"""The port's train step against the JAX package, on the CPU (continued
from ``tests/test_torch_train_step.py``, whose docstring states the
setup): the loss and gradients of rwkv6-1.6b, whisper-large-v3 and
internvl2-76b at ``smoke_config`` and 2 layers, then two
``make_train_step`` steps of granite-3-2b with ``microbatches`` 1 and 2
from one state: loss, grad norm and step metrics, both steps' counts, and
every parameter after them.

The steps run AdamW with ``eps = 1e-3``, so that an update is a smooth
function of its gradient (with the default 1e-8, a first step moves each
entry by the learning rate times the sign of its gradient, and an entry
whose gradient is near 0 in both packages may move either way).
Tolerances: the loss within 1e-5 relative and the grad norm within 1e-4
(sums in another order); each parameter within 1e-6 absolute after two
steps of learning rate 1e-3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.sharding import UNSHARDED
from repro.optim import adamw as ref_adamw
from repro.train import make_train_step as ref_make_step
from repro_torch.models import transformer
from repro_torch.optim import adamw
from repro_torch.train import make_train_step
from test_torch_train_step import LR, check_loss_and_gradients, flat, setup

EPS = 1e-3


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "whisper-large-v3",
                                  "internvl2-76b"])
def test_train_loss_and_gradients_match_jax(arch):
    check_loss_and_gradients(arch)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_two_train_steps_match_reference(microbatches):
    arch = "granite-3-2b"
    ref_cfg, cfg, rs, state, batch = setup(arch, ref_adamw(LR, eps=EPS))
    ref_step = jax.jit(ref_make_step(ref_cfg, ref_adamw(LR, eps=EPS),
                                     UNSHARDED, microbatches))
    step = make_train_step(cfg, adamw(LR, eps=EPS), microbatches)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    for _ in range(2):
        rs, rm = ref_step(rs, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = step(state, tb)
        assert float(m["loss"]) == pytest.approx(float(rm["loss"]), rel=1e-5)
        assert float(m["grad_norm"]) == pytest.approx(float(rm["grad_norm"]),
                                                      rel=1e-4)
        assert float(m["step"]) == float(rm["step"])
    assert int(state.step) == int(rs.step) == 2
    assert int(state.opt.step) == int(rs.opt.step) == 2
    want = flat(rs.params)
    for key, p in transformer.flat_params(state.params).items():
        np.testing.assert_allclose(p.numpy(), want[key], rtol=0, atol=1e-6,
                                   err_msg=f"{arch} {key}")
