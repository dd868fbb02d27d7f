#!/usr/bin/env python3
"""Time and fingerprint the segment sum, the keyless pass, K7's backward,
a GNN step and DeepSeek-V2-Lite's train step in two source trees, in turns,
on one CUDA card.

    python3 tools/slice_ab.py --tree OTHER [--json PATH]

Run from the root of a checkout; ``OTHER`` is another checkout's root (an
older commit unpacked with ``git archive``).  The trees run in four worker
processes, other / this / this / other, each with its own ``src`` first on
``sys.path`` and its own kernel build; every worker makes the same inputs
from seed 0 and records, for each call, CUDA-event ms (20 back-to-back
calls after one) and a SHA-1 of the output's bytes, so that two trees'
outputs can be compared bit for bit:

* the segment sum (``kernels.segment_sum``): ``csr_spmm``'s forward and X's
  gradient on ogbn-arxiv's Â (64 columns; float32 and bf16), the MoE
  gathers' backward at DeepSeek-V2-Lite's training shape (``index_sum`` of
  4,096 x 6 bf16 rows of 2,048), and the sort engine's group-2 chunk of
  p2p-Gnutella04 (one column);
* the keyless pass at K7_KEYLESS (forward and the backward's dV sum);
* K7's backward at granite-3-2b's training shape (BH 64, S 2,048, D 64),
  bf16 and float16;
* ``train_gnn``'s gcn / topk step on ogbn-arxiv (2 steps profiled: device
  ms, and the segment sum's share);
* DeepSeek-V2-Lite's train step at DS_TRAIN (4 layers): the median wall of
  5 steps after one, and one profiled step's device ms and its time in
  PyTorch's indexing backward and in the segment sum.

It prints the card's name and power limit first and one JSON object last,
and exits non-zero without a CUDA device.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def digest(x) -> str:
    import torch

    if isinstance(x, (tuple, list)):
        return hashlib.sha1("".join(digest(t) for t in x).encode()) \
            .hexdigest()[:16]
    return hashlib.sha1(x.detach().contiguous().view(torch.uint8).cpu()
                        .numpy().tobytes()).hexdigest()[:16]


def measure(cs) -> dict:
    """Every call's ms and digest in the tree on ``sys.path``."""
    import numpy as np
    import torch

    from repro_torch.apps import gnn
    from repro_torch.apps.graphs import rmat_graph, table_ii_matrix
    from repro_torch.core import phases
    from repro_torch.kernels import flash_attention as k7
    from repro_torch.kernels import ops
    from repro_torch.kernels import segment_sum as ss
    from repro_torch.sparse import ops as sparse_ops

    out = {}

    def record(name, fn):
        got = fn()
        torch.cuda.synchronize()
        out[name] = {"loop_ms": cs.loop_ms(fn, reps=20), "digest": digest(got)}

    # the segment sum
    g = rmat_graph(cs.GNN["nodes"], cs.GNN["avg_deg"], seed=0, device="cuda")
    a = gnn.normalize_adjacency(g)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(
        (cs.GNN["nodes"], cs.GNN["d"])).astype(np.float32)).cuda()
    ct = torch.from_numpy(rng.standard_normal(
        (cs.GNN["nodes"], cs.GNN["d"])).astype(np.float32)).cuda()
    with cs.recorded_sums(sparse_ops, ss) as calls:
        sparse_ops.csr_spmm(a, x.clone().requires_grad_(),
                            gather="aia").backward(ct)
    for (ids, vals, n_out, order, _), what in zip(calls, ("fwd", "dX")):
        for dt in (torch.float32, torch.bfloat16):
            v = vals.to(dt)
            record(f"segment_sum/csr_spmm_{what}/{dt}",
                   lambda ids=ids, v=v, n_out=n_out, order=order:
                   ss.segment_sum(ids, v, n_out, order))
    ids, ctm = cs.moe_gather_operands()
    record("segment_sum/moe_backward",
           lambda: ss.index_sum(ids, ctm, cs.MOE_GATHER["tokens"]))
    mat = table_ii_matrix("p2p-Gnutella04", seed=0,
                          n_override=cs.MATRICES["p2p-Gnutella04"],
                          device="cuda")
    ell, firsts = cs.chunk_operands(mat)
    item, rows = firsts[2]
    cols_a, vals_a = phases.gather_group_rows(mat.indptr, mat.indices,
                                              mat.data, rows, item.a_cap)
    keys, pvals = phases.enumerate_products(cols_a, vals_a, ell.indices,
                                            ell.data)
    out_cap = int(phases.allocate_sort(keys).max())
    with cs.recorded_sums(phases) as calls:
        phases.sort_unique(keys, pvals, out_cap)
    sids, svals, sn, sorder, sskip = calls[0]
    record("segment_sum/sort_unique_p2p_g2",
           lambda: ss.segment_sum(sids, svals, sn, sorder, sskip))
    del g, a, x, ct, calls, ids, ctm, mat, ell, keys, pvals, sids, svals
    torch.cuda.empty_cache()

    # the keyless pass
    gen = torch.Generator(device="cuda").manual_seed(0)
    bh, s, d = cs.K7_KEYLESS
    q, k, v = (torch.randn((bh, s, d), generator=gen, device="cuda")
               .bfloat16() for _ in range(3))
    record("keyless/fwd", lambda: ops.flash_attention_masked(q, k, v, False,
                                                             kv_len=0))
    gk = torch.empty((bh, d), dtype=torch.float32, device="cuda")

    def keyless_bwd():
        k7._keyless(v, gk, None, s, s, s, None, 1024, False)
        return gk
    record("keyless/bwd", keyless_bwd)

    # K7's backward
    for dt in (torch.bfloat16, torch.float16):
        q, k, v, do = (torch.randn((64, 2048, 64), generator=gen,
                                   device="cuda").to(dt) for _ in range(4))
        o, lse = k7._launch(q, k, v, True, 0, 0, 2048, with_lse=True)
        record(f"k7_bwd/granite/{dt}",
               lambda q=q, k=k, v=v, o=o, lse=lse, do=do: k7._launch_bwd(
                   q, k, v, o, lse, do, True, 0, 0, 2048))
    del q, k, v, do, o, lse
    torch.cuda.empty_cache()

    # a GNN step
    dgnn = cs.gnn_inputs()
    cfg = gnn.GNNConfig(arch="gcn", d_in=cs.GNN["d"], d_hidden=cs.GNN["d"],
                        n_classes=cs.GNN["n_classes"], topk=cs.GNN["topk"],
                        sparse_mode="topk", n_layers=cs.GNN["n_layers"])

    def gnn_steps():
        return gnn.train_gnn(cfg, dgnn["a"], dgnn["x"], dgnn["labels"],
                             n_steps=2, seed=0)
    gnn_steps()
    host_ms, dev_ms, events = cs.profile(gnn_steps, top_n=None)
    out["gnn/gcn/topk/2_steps"] = {
        "host_ms": host_ms, "device_ms": dev_ms,
        "segment_sum_ms": sum(t for n, t, _ in events if "segment_sum" in n
                              or "mark_runs" in n),
        "loss": gnn_steps()[1]}
    del dgnn
    torch.cuda.empty_cache()

    # DeepSeek-V2-Lite's train step
    from repro_torch.train import init_train_state

    spec = cs.DS_TRAIN
    cfg, opt, _, step, pipe = cs.train_setup(spec)
    state = init_train_state(cfg, torch.Generator(device="cuda")
                             .manual_seed(0), opt, "cuda")
    state, m = step(state, cs.batch_on_card(pipe, 0))
    wall, metrics = [], [{k: float(x) for k, x in m.items()}]
    for i in range(1, 1 + spec["timed_steps"]):
        batch = cs.batch_on_card(pipe, i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        metrics.append({k: float(x) for k, x in m.items()})
    batch = cs.batch_on_card(pipe, 1 + spec["timed_steps"])
    box = {}

    def one():
        box["state"], box["m"] = step(state, batch)
    host_ms, dev_ms, events = cs.profile(one, top_n=None)
    out["deepseek_train_step"] = {
        "step_ms": wall, "median_step_ms": statistics.median(wall),
        "profiled_host_ms": host_ms, "profiled_device_ms": dev_ms,
        "indexing_backward_ms": sum(t for n, t, _ in events
                                    if "indexing_backward" in n),
        "segment_sum_ms": sum(t for n, t, _ in events if "segment_sum" in n
                              or "mark_runs" in n),
        "losses": [mm["loss"] for mm in metrics],
        "grad_norms": [mm["grad_norm"] for mm in metrics]}
    return out


def worker(src: str) -> int:
    import torch

    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(pathlib.Path(src) / "src"))
    import chip_smoke as cs
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.library()
    rec = {"tree": src, "build_s": time.perf_counter() - t0,
           **measure(cs)}
    print("RESULT " + json.dumps(rec), flush=True)
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", help="the other checkout's root")
    parser.add_argument("--worker", help=argparse.SUPPRESS)
    parser.add_argument("--json", help="also write the results to this file")
    args = parser.parse_args(argv)
    if args.worker:
        return worker(args.worker)

    import torch

    if not torch.cuda.is_available():
        print("slice_ab: no CUDA device is available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    other = str(pathlib.Path(args.tree).resolve())
    runs = []
    for tree in (other, str(ROOT), str(ROOT), other):
        proc = subprocess.run(
            [sys.executable, __file__, "--worker", tree], cwd=str(ROOT),
            capture_output=True, text=True,
            env={**os.environ, "PYTHONPATH": str(pathlib.Path(tree) / "src")})
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("RESULT ")]
        if proc.returncode or not lines:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        runs.append(json.loads(lines[-1][len("RESULT "):]))
        print(json.dumps({"tree": tree, "build_s": runs[-1]["build_s"]}),
              flush=True)
    keys = [k for k in runs[0] if k not in ("tree", "build_s")]
    summary = {}
    for k in keys:
        o1, t1, t2, o2 = (r[k] for r in runs)
        row = {"other": [o1, o2], "this": [t1, t2]}
        if "digest" in o1:
            row["same_bits_across_trees"] = o1["digest"] == t1["digest"]
            row["same_bits_on_repeat"] = (o1["digest"] == o2["digest"]
                                          and t1["digest"] == t2["digest"])
        summary[k] = row
    record = {"nvidia_smi": smi, "order": "other, this, this, other",
              "results": summary}
    if args.json:
        pathlib.Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.json).write_text(json.dumps(record, indent=1))
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
