"""The port's dry run (``launch.dryrun``) on the CPU.

The reference lowers and compiles each cell on 512 forced host devices
(its own test of that fails under jax 0.9, ROADMAP Queue C); the port
traces the cell on the meta device under torch's fake process group.  The
fake group is the process's default group, so each check runs in a
subprocess and none leaks into later tests on this worker.

* granite-3-2b ``decode_32k`` on both production meshes through the CLI:
  a record a mesh, ``flops_per_device > 0``, CUDA never initialised;
* at the smoke size on a fake (2, 2) mesh, per-device FLOPs x 4 against
  ``FlopCounterMode``'s count of the same step in one process, for each
  kind of cell: between 1 and 1.25 times it (work that the model dim
  repeats, such as the loss's gathered logits in the backward, adds to the
  sum; none is lost); and ``measure_cell``'s extrapolation from 1 and 2
  layers equal to the 4-layer trace.
"""
import json
import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, timeout=600):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    proc = subprocess.run([sys.executable, *args], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, f"STDOUT:\n{proc.stdout}\nSTDERR:\n" \
                                 f"{proc.stderr[-4000:]}"
    return proc.stdout


def test_dryrun_single_cell_multipod(tmp_path):
    out = tmp_path / "cells.json"
    _run(["-m", "repro_torch.launch.dryrun", "--arch", "granite-3-2b",
          "--shape", "decode_32k", "--multi-pod", "--json", str(out)])
    recs = json.loads(out.read_text())
    assert [r["mesh"] for r in recs] == [
        {"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16}]
    for r in recs:
        assert r["arch"] == "granite-3-2b" and r["shape"] == "decode_32k"
        assert r["flops_per_device"] > 0
        assert r["bytes_accessed_per_device"] > 0
        assert r["memory"]["argument_bytes"] > 0
        assert r["cuda_initialized"] is False
    # the multi-pod mesh halves each device's batch
    assert recs[1]["memory"]["argument_bytes"] < \
        recs[0]["memory"]["argument_bytes"]


def test_smoke_flops_match_one_process():
    out = _run(["-c", textwrap.dedent("""
    import dataclasses, json
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import smoke_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adamw
    from repro_torch.train.step import init_train_state, make_train_step

    cfg = dataclasses.replace(smoke_config("granite-3-2b"), n_layers=2)
    out = {}
    for kind, seq, b in (("train", 32, 4), ("prefill", 32, 4),
                         ("decode", 64, 4)):
        shape = ShapeSpec("smoke_" + kind, seq, b, kind)
        with dryrun.fake_mesh((2, 2), ("data", "model")) as mesh:
            rec = dryrun.lower_cell(cfg, shape, mesh, verbose=False)
        state = init_train_state(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
        tok = torch.zeros((b, seq), dtype=torch.int64)
        with FlopCounterMode(display=False) as fc:
            if kind == "train":
                make_train_step(cfg, adamw(3e-4))(
                    state, {"tokens": tok, "labels": tok})
            elif kind == "prefill":
                h, _ = tf.forward_hidden(cfg, state.params, tok)
                h[:, -1:] @ state.params["lm_head"]
            else:
                cache = tf.init_decode_cache(cfg, b, seq, device="cpu")
                tf.decode_step(cfg, state.params, cache, tok[:, :1])
        out[kind] = (rec["flops_per_device"], fc.get_total_flops())
    # measure_cell: 1- and 2-layer traces extrapolated to 4 layers
    cfg4 = dataclasses.replace(cfg, n_layers=4)
    shape = ShapeSpec("smoke_decode", 64, 4, "decode")
    with dryrun.fake_mesh((2, 2), ("data", "model")) as mesh:
        whole = dryrun.lower_cell(cfg4, shape, mesh, verbose=False)
        measured = dryrun.measure_cell(cfg4, shape, mesh, verbose=False)
    out["measure"] = (measured["flops_per_device"],
                      whole["flops_per_device"])
    print(json.dumps(out))
    """)])
    got = json.loads(out.strip().splitlines()[-1])
    measured, whole = got.pop("measure")
    assert measured == whole  # every layer costs the same
    for kind, (per_device, single) in got.items():
        assert single > 0, kind
        assert single <= 4 * per_device <= 1.25 * single, (kind, per_device,
                                                            single)
