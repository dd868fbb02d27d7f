"""The port's train step against the JAX package, on the CPU, one config
per family: ``smoke_config`` at 2 layers (float32) of granite-3-2b (GQA),
deepseek-v2-lite-16b (MLA + MoE with its dense prefix layer), zamba2-1.2b
(Mamba2 + the windowed shared block) here; rwkv6-1.6b, whisper-large-v3
(encoder-decoder over stub frames), internvl2-76b (vision stub) and two
``make_train_step`` steps in
``tests/test_torch_train_step_steps.py`` (the reference compiles each
config's loss once, and one file would take past 40 s).

Both packages start from one state: the reference's ``init_train_state``
draws it and ``train_state_from_numpy`` carries its parameters, AdamW
moments and steps across by tree path.  Checked: the loss and every
gradient of ``train_loss`` against ``jax.value_and_grad``.  Inputs come
from ``data.synthetic_batch`` with a numpy seed.

Tolerances: the two sum in another order (the attention's blocks, K7's
scale rounded from double, matmuls, the chunked scans): the loss within
1e-5 relative; each gradient leaf within 1e-4 of its largest |value| (1e-3
for MoE, whose routing weights are gathered and combined in another
order).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as ref_smoke
from repro.launch.sharding import UNSHARDED
from repro.models import transformer as ref_tf
from repro.optim import adamw as ref_adamw
from repro.train import init_train_state as ref_init_state
from repro_torch import configs
from repro_torch.data import synthetic_batch
from repro_torch.models import transformer
from repro_torch.train import train_state_from_numpy

ARCHS = ["granite-3-2b", "deepseek-v2-lite-16b", "zamba2-1.2b"]
LR = 1e-3


@dataclasses.dataclass
class _Shape:
    global_batch: int = 2
    seq_len: int = 16


def flat(tree):
    """A reference tree as {"layers/attn/wq": ndarray}."""
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(p, "key", getattr(p, "name",
                                                   getattr(p, "idx", p))))
                     for p in path): np.asarray(leaf) for path, leaf in leaves}


_INIT = {}


def setup(arch, opt=None):
    """(reference cfg, port cfg, reference state, the port's copy of it,
    numpy batch) at 2 layers; the reference's state drawn under ``jit``."""
    ref_cfg = dataclasses.replace(ref_smoke(arch), n_layers=2)
    cfg = dataclasses.replace(configs.smoke_config(arch), n_layers=2)
    if arch not in _INIT:  # AdamW's initial state is zeros, whatever opt
        _INIT[arch] = jax.jit(lambda key: ref_init_state(
            ref_cfg, key, opt or ref_adamw(LR)))(jax.random.PRNGKey(0))
    rs = _INIT[arch]
    batch = synthetic_batch(cfg, _Shape(), np.random.default_rng(5))
    port = train_state_from_numpy(cfg, flat(rs.params), flat(rs.opt.mu),
                                  flat(rs.opt.nu), step=int(rs.step),
                                  opt_step=int(rs.opt.step), device="cpu")
    return ref_cfg, cfg, rs, port, batch


def check_loss_and_gradients(arch):
    ref_cfg, cfg, rs, port, batch = setup(arch)
    ref_loss, ref_g = jax.jit(jax.value_and_grad(
        lambda p: ref_tf.train_loss(ref_cfg, p, batch, UNSHARDED)))(rs.params)
    ref_g = flat(ref_g)
    live = {k: p.detach().requires_grad_()
            for k, p in transformer.flat_params(port.params).items()}
    assert sorted(live) == sorted(ref_g) == sorted(transformer.param_keys(cfg))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss = transformer.train_loss(cfg, transformer.tree_params(cfg, live), tb)
    grads = torch.autograd.grad(loss, list(live.values()), allow_unused=True)
    assert float(loss.detach()) == pytest.approx(float(ref_loss), rel=1e-5)
    for key, g in zip(live, grads):
        want = ref_g[key]
        got = np.zeros_like(want) if g is None else g.numpy()
        tol = 1e-3 if arch == "deepseek-v2-lite-16b" else 1e-4
        bound = tol * max(float(np.abs(want).max()), 1e-30)
        err = float(np.abs(got - want).max())
        assert err <= bound, f"{arch} {key}: max |error| {err} > {bound}"


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_gradients_match_jax(arch):
    check_loss_and_gradients(arch)
