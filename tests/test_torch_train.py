"""The port's training substrate against the JAX package, on the CPU: the
counterparts of ``tests/test_substrate.py``'s optimizer, schedule,
compression, checkpoint, pipeline, trainer and straggler tests and of
``tests/test_resilience.py``'s trainer-recovery tests.

Tolerances: the optimizers and schedules repeat the reference's float32
elementwise arithmetic (AdamW's ``sqrt`` and the schedules' ``cos`` are
another library's): within 1e-6 relative / 1e-7.  int8 compression rounds
``x / scale`` to integers: the codes must be equal and the scales within
one float32 ulp.  The pipeline is a numpy copy: its batches are bit for bit
the reference's.  The trainers run ``smoke_config("granite-3-2b")`` at 2
layers from one state in float32; their losses sum in another order
(attention blocks, matmuls): within 1e-4 relative.  Checkpoints and replay
are bit for bit.
"""
import dataclasses
import json
import os
import tempfile
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as ref_optim
from repro.configs import smoke_config as ref_smoke
from repro.data.pipeline import TokenPipeline as RefPipeline
from repro.train import Trainer as RefTrainer
from repro.train import TrainerConfig as RefTrainerConfig
from repro.train import init_train_state as ref_init_state
from repro.train import make_train_step as ref_make_step
from repro_torch import configs, optim
from repro_torch.checkpoint import (AsyncCheckpointer, latest_step,
                                    restore_checkpoint, save_checkpoint,
                                    tree_leaves)
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.train import (StragglerMonitor, Trainer, TrainerConfig,
                               make_train_step, train_state_from_numpy)

RTOL, ATOL = 1e-6, 1e-7


def host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def flat(tree):
    """A reference tree as {"layers/attn/wq": ndarray}."""
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(p, "key", getattr(p, "name", p)))
                     for p in path): np.asarray(leaf) for path, leaf in leaves}


# ---------------------------------------------------------------------------
# Optimizers, schedules, compression
# ---------------------------------------------------------------------------

def _run_both(make_opt, params, loss, steps):
    """``steps`` optimizer steps of the reference and the port from the same
    parameters, each with its own framework's gradient."""
    ref_opt, opt = make_opt(ref_optim), make_opt(optim)
    rp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(np.array(v)) for k, v in params.items()}
    rs, ts = ref_opt.init(rp), opt.init(tp)
    for _ in range(steps):
        g = jax.grad(lambda p: loss(p, jnp))(rp)
        upd, rs = ref_opt.update(g, rs, rp)
        rp = ref_optim.apply_updates(rp, upd)
        live = {k: v.clone().requires_grad_() for k, v in tp.items()}
        keys = sorted(live)
        tg = dict(zip(keys, torch.autograd.grad(loss(live, torch),
                                                [live[k] for k in keys])))
        upd, ts = opt.update(tg, ts, tp)
        tp = optim.apply_updates(tp, upd)
    return rp, tp


def _quad(p, xp):
    return xp.sum(p["w"] ** 2) + p["b"] ** 2


def test_adamw_minimizes_quadratic_as_the_reference():
    params = {"w": np.array([1.0, -2.0, 3.0], np.float32),
              "b": np.array(0.5, np.float32)}
    rp, tp = _run_both(lambda o: o.adamw(0.1, weight_decay=0.0), params,
                       _quad, 100)
    assert float(_quad(tp, torch)) < 1e-3 * float(_quad(params, np))
    for k in params:
        np.testing.assert_allclose(host(tp[k]), np.asarray(rp[k]),
                                   rtol=1e-5, atol=1e-6)


def test_adamw_weight_decay_shrinks_as_the_reference():
    params = {"w": np.ones(4, np.float32)}
    rp, tp = _run_both(lambda o: o.adamw(0.01, weight_decay=0.5), params,
                       lambda p, xp: 0.0 * xp.sum(p["w"]), 10)
    assert float(tp["w"].max()) < 1.0
    np.testing.assert_allclose(host(tp["w"]), np.asarray(rp["w"]),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_matches_reference(momentum):
    params = {"w": np.array([4.0], np.float32)}
    rp, tp = _run_both(lambda o: o.sgd(0.05, momentum=momentum), params,
                       lambda p, xp: xp.sum(p["w"] ** 2), 100)
    if momentum:
        assert abs(float(tp["w"][0])) < 0.1
    np.testing.assert_allclose(host(tp["w"]), np.asarray(rp["w"]),
                               rtol=1e-5, atol=1e-7)


def test_clip_by_global_norm_matches_reference():
    for fill in (10.0, 0.01):
        g = {"a": np.full(4, fill, np.float32), "b": np.full(9, fill,
                                                             np.float32)}
        rc, rn = ref_optim.clip_by_global_norm(
            {k: jnp.asarray(v) for k, v in g.items()}, 1.0)
        tc, tn = optim.clip_by_global_norm(
            {k: torch.from_numpy(v) for k, v in g.items()}, 1.0)
        np.testing.assert_allclose(float(tn), float(rn), rtol=RTOL)
        for k in g:
            np.testing.assert_allclose(host(tc[k]), np.asarray(rc[k]),
                                       rtol=RTOL, atol=ATOL)
    assert float(optim.global_norm(tc)) == pytest.approx(0.01 * 13 ** 0.5,
                                                         rel=1e-6)


def test_schedules_match_reference():
    cases = [(lambda o: o.cosine_schedule(1.0, 100), (0, 1, 37, 100, 150)),
             (lambda o: o.linear_warmup_cosine(1.0, 10, 110),
              (0, 5, 9, 10, 11, 60, 110, 200)),
             (lambda o: o.linear_warmup_cosine(3e-4, 20, 6), (0, 3, 6))]
    for make, steps in cases:
        ref, port = make(ref_optim), make(optim)
        for s in steps:
            want = float(ref(jnp.asarray(s, jnp.int32)))
            got = float(port(torch.tensor(s, dtype=torch.int32)))
            assert got == pytest.approx(want, rel=RTOL, abs=ATOL), (s, got)
    wc = optim.linear_warmup_cosine(1.0, 10, 110)
    assert float(wc(torch.tensor(5))) == pytest.approx(0.5, abs=1e-6)
    assert float(wc(torch.tensor(10))) == pytest.approx(1.0, abs=1e-4)


@pytest.mark.parametrize("seed", range(5))
def test_int8_compression_matches_reference(seed):
    rng = np.random.default_rng(seed)
    scale = 10.0 ** rng.uniform(-3, 3)
    x = (rng.standard_normal(64) * scale).astype(np.float32)
    rq, rs = ref_optim.int8_compress(jnp.asarray(x))
    q, s = optim.int8_compress(torch.from_numpy(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert abs(int(np.float32(float(s)).view(np.int32))
               - int(np.float32(rs).view(np.int32))) <= 1
    y = optim.int8_decompress(q, s)
    amax = float(np.abs(x).max())
    assert float((y - torch.from_numpy(x)).abs().max()) \
        <= amax / 127.0 * 0.5 + 1e-7
    zq, zs = optim.int8_compress(torch.zeros(3))
    assert float(zs) == 1.0 and not zq.any()


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

def _tree():
    return {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "nested": {"b": torch.tensor([1, 2, 3], dtype=torch.int32),
                       "w": torch.linspace(-3, 3, 7).to(torch.bfloat16)},
            "scalar": torch.tensor(7, dtype=torch.int32)}


def test_checkpoint_roundtrip_bit_for_bit():
    with tempfile.TemporaryDirectory() as d:
        t = _tree()
        save_checkpoint(d, 5, t)
        assert latest_step(d) == 5
        target = {"a": torch.zeros(3, 4),
                  "nested": {"b": torch.zeros(3, dtype=torch.int32),
                             "w": torch.zeros(7, dtype=torch.bfloat16)},
                  "scalar": torch.tensor(0, dtype=torch.int32)}
        restored = restore_checkpoint(d, 5, target)
        for got, want in zip(tree_leaves(restored), tree_leaves(t)):
            assert got.dtype == want.dtype and torch.equal(got, want)
        # leaves in the reference's order: sorted keys
        with open(os.path.join(d, "step_5", "manifest.json")) as f:
            man = json.load(f)
        assert [m["dtype"] for m in man["leaves"]] == [
            "float32", "int32", "bfloat16", "int32"]
        assert man["n_leaves"] == 4


def test_checkpoint_corruption_detected():
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, 1, _tree())
        path = os.path.join(d, "step_1", "leaf_0.npy")
        with open(path, "r+b") as f:
            f.seek(-1, 2)
            f.write(b"\x00")
        with pytest.raises(IOError):
            restore_checkpoint(d, 1, _tree())


def test_async_checkpointer_overlap():
    with tempfile.TemporaryDirectory() as d:
        ck = AsyncCheckpointer(d)
        t = _tree()
        ck.save(3, t)
        t["a"] += 1  # the snapshot was taken at save()
        ck.wait()
        assert latest_step(d) == 3
        assert torch.equal(restore_checkpoint(d, 3, t)["a"], t["a"] - 1)


def test_checkpoint_latest_ignores_partial():
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, 2, _tree())
        os.makedirs(os.path.join(d, "step_9"))  # no manifest -> partial
        assert latest_step(d) == 2


# ---------------------------------------------------------------------------
# Data pipeline
# ---------------------------------------------------------------------------

def test_pipeline_batches_are_the_reference_bit_for_bit():
    for kw in (dict(vocab=100, seq_len=16, global_batch=4, seed=7),
               dict(vocab=49155, seq_len=64, global_batch=2, seed=0),
               dict(vocab=50, seq_len=8, global_batch=8, seed=1,
                    local_slice=slice(2, 4))):
        p, r = TokenPipeline(**kw), RefPipeline(**kw)
        for step in (0, 3, 17):
            b, rb = p.batch_at(step), r.batch_at(step)
            for key in ("tokens", "labels"):
                assert b[key].dtype == rb[key].dtype == np.int32
                np.testing.assert_array_equal(b[key], rb[key])
    p1 = TokenPipeline(vocab=100, seq_len=16, global_batch=4, seed=7)
    assert not np.array_equal(p1.batch_at(0)["tokens"],
                              p1.batch_at(1)["tokens"])


def test_pipeline_local_slice_and_shifted_labels():
    p = TokenPipeline(vocab=50, seq_len=8, global_batch=8, seed=1,
                      local_slice=slice(2, 4))
    b = p.batch_at(0)
    assert b["tokens"].shape == (2, 8)
    full = TokenPipeline(vocab=50, seq_len=8, global_batch=8,
                         seed=1).batch_at(0)
    np.testing.assert_array_equal(b["tokens"], full["tokens"][2:4])
    np.testing.assert_array_equal(full["tokens"][:, 1:],
                                  full["labels"][:, :-1])


def test_synthetic_batch_matches_reference():
    from repro.configs.base import SHAPE_SETS as REF_SHAPES
    from repro.data.pipeline import synthetic_batch as ref_batch
    from repro_torch.configs.base import SHAPE_SETS
    from repro_torch.data import synthetic_batch
    for arch in ("whisper-large-v3", "internvl2-76b"):
        cfg = configs.smoke_config(arch)
        got = synthetic_batch(cfg, SHAPE_SETS[0], np.random.default_rng(4), 2)
        want = ref_batch(ref_smoke(arch), REF_SHAPES[0],
                         np.random.default_rng(4), 2)
        assert sorted(got) == sorted(want)
        for key in got:
            np.testing.assert_array_equal(got[key], want[key])


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------

_STATE = {}


def _start():
    """(port cfg, reference state, the port's copy of it)."""
    if not _STATE:
        ref_cfg = dataclasses.replace(ref_smoke("granite-3-2b"), n_layers=2)
        cfg = dataclasses.replace(configs.smoke_config("granite-3-2b"),
                                  n_layers=2)
        rs = ref_init_state(ref_cfg, jax.random.PRNGKey(0))
        _STATE.update(ref_cfg=ref_cfg, cfg=cfg, ref=rs)
    cfg = _STATE["cfg"]
    rs = _STATE["ref"]
    port = train_state_from_numpy(
        cfg, flat(rs.params), flat(rs.opt.mu), flat(rs.opt.nu),
        step=int(rs.step), opt_step=int(rs.opt.step), device="cpu")
    return cfg, rs, port


def _tiny_trainer(tmpdir, failure_injector=None, total_steps=12):
    cfg, _, state = _start()
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=16, global_batch=2, seed=3)
    tc = TrainerConfig(total_steps=total_steps, checkpoint_every=4,
                       checkpoint_dir=tmpdir, max_restarts=3)
    return Trainer(tc, make_train_step(cfg), state, pipe,
                   failure_injector=failure_injector)


def test_trainer_runs_and_checkpoints_as_the_reference():
    with tempfile.TemporaryDirectory() as d:
        tr = _tiny_trainer(d)
        state = tr.run()
        assert int(state.step) == 12 and latest_step(d) == 12
        losses = [m["loss"] for m in tr.history]
        assert all(np.isfinite(losses))
    _, rs, _ = _start()
    with tempfile.TemporaryDirectory() as d:
        ref = RefTrainer(
            RefTrainerConfig(total_steps=12, checkpoint_every=4,
                             checkpoint_dir=d, max_restarts=3),
            jax.jit(ref_make_step(_STATE["ref_cfg"])), rs,
            RefPipeline(vocab=_STATE["cfg"].vocab, seq_len=16,
                        global_batch=2, seed=3))
        ref.run()
    for key in ("loss", "grad_norm", "step"):
        np.testing.assert_allclose([m[key] for m in tr.history],
                                   [m[key] for m in ref.history], rtol=1e-4)


def test_trainer_recovers_from_failure_bit_identically():
    """Kill step 6 once; the final state must equal the clean run's, and the
    replayed steps' metrics the first pass's."""
    with tempfile.TemporaryDirectory() as d1:
        clean_tr = _tiny_trainer(d1)
        clean = clean_tr.run()
    killed = {"done": False}

    def inject(step):
        if step == 6 and not killed["done"]:
            killed["done"] = True
            raise RuntimeError("simulated device failure")

    with tempfile.TemporaryDirectory() as d2:
        tr = _tiny_trainer(d2, failure_injector=inject)
        recovered = tr.run()
        assert tr.restarts == 1
    assert [(m["loss"], m["grad_norm"]) for m in tr.history[4:6]] == \
        [(m["loss"], m["grad_norm"]) for m in tr.history[6:8]]
    for a, b in zip(tree_leaves(clean), tree_leaves(recovered)):
        assert torch.equal(a, b)


def test_straggler_monitor():
    m = StragglerMonitor(alpha=0.5, threshold=2.0)
    for i in range(5):
        assert not m.observe(i, 1.0)
    assert m.observe(5, 10.0)  # 10x slower than the EWMA: flagged
    assert m.flagged == [5]


# ---------------------------------------------------------------------------
# Trainer: narrowed recovery (tests/test_resilience.py's satellite)
# ---------------------------------------------------------------------------

class _State(NamedTuple):
    step: torch.Tensor
    w: torch.Tensor


def _toy_trainer(tmpdir, failure_injector, total_steps=4):
    def step_fn(state, batch):
        return _State(step=state.step + 1, w=state.w + 1.0), {"loss": 0.0}

    cfg = TrainerConfig(total_steps=total_steps, checkpoint_every=1,
                        checkpoint_dir=tmpdir, max_restarts=2)
    pipe = TokenPipeline(vocab=16, seq_len=4, global_batch=1, seed=0)
    state = _State(step=torch.tensor(0), w=torch.zeros(2))
    return Trainer(cfg, step_fn, state, pipe,
                   failure_injector=failure_injector,
                   to_device=lambda b: b)


def test_trainer_programming_errors_propagate(tmp_path):
    def inject(step):
        raise TypeError("not a device failure")

    tr = _toy_trainer(str(tmp_path), inject)
    with pytest.raises(TypeError, match="not a device failure"):
        tr.run()
    assert tr.restarts == 0 and tr.failures == []


def test_trainer_records_and_logs_recovered_failures(tmp_path, caplog):
    killed = {"done": False}

    def inject(step):
        if step == 2 and not killed["done"]:
            killed["done"] = True
            raise RuntimeError("simulated preemption")

    tr = _toy_trainer(str(tmp_path), inject)
    with caplog.at_level("WARNING", logger="repro_torch.train.trainer"):
        state = tr.run()
    assert int(state.step) == 4 and torch.equal(state.w, torch.full((2,), 4.))
    assert tr.restarts == 1
    assert tr.failures == [(2, repr(RuntimeError("simulated preemption")))]
    assert any("restart 1/2" in r.message for r in caplog.records)


def test_launch_train_smoke_on_cpu(capsys, tmp_path):
    from repro_torch.launch import train as launch_train
    tr = launch_train.main(["--arch", "granite-3-2b", "--smoke", "--steps",
                            "3", "--device", "cpu", "--ckpt-dir",
                            str(tmp_path), "--ckpt-every", "2"])
    out = capsys.readouterr().out
    assert "device=cpu" in out and "[train] done: loss" in out
    assert latest_step(str(tmp_path)) == 3 and len(tr.history) == 3
