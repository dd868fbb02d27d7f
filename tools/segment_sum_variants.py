#!/usr/bin/env python3
"""Time the segment-sum kernel's W > 1 schedules on one CUDA card, in turns.

    python3 tools/segment_sum_variants.py [--parent PATH] [--json PATH]

Run from the root of a checkout.  Each variant is
``src/repro_torch/kernels/csrc/segment_sum.cu`` with a constant or a line
changed, compiled by its own ``nvcc`` (all started together) into a
shared library under ``build/segment_sum_variants/``:

* ``source``: the source as it is;
* ``no_block``: ``kLongRun`` 0, every run on the warp route: the runs'
  bounds marked once, short runs packed, but a long run one lane's chain
  of loads (what the block route saves);
* ``long_64`` ... ``long_2048``: ``kLongRun`` 64 to 2,048, the threshold
  of the block route;
* ``float32_adds``: 16-bit values added in float32 and rounded at every
  add, as the W = 1 kernel adds them, in place of the native 16-bit adds
  (the same bits);
* ``lanes_32``: a warp a segment whatever the row's width (what packing
  short runs saves);
* ``batch_4``, ``batch_16``: 4 or 16 rows' loads in flight a lane (8 in
  the source);
* ``stages_2``: a two-tile ring on the block route (3 in the source);
* ``parent`` (with ``--parent``, a copy of the kernel's source before the
  W > 1 redesign, whose entry takes no scratch): a warp
  a segment, its run found by two binary searches over all ids.

Inputs, from seed 0 (``chip_smoke.py``'s GNN shape: ogbn-arxiv's Â, 64
columns): ``csr_spmm``'s forward and X's gradient (the stable sort's
permutation), in float32 and bf16; the forward with every run longer than
``kLongRun`` taken out (what the longest runs cost); and the MoE gathers'
backward at DeepSeek-V2-Lite's training shape (4,096 tokens x 6 pairs of
2,048 bf16 columns, runs of 6).  Every variant's output must equal the
plain version's on the CPU bit for bit.  The time of each call is CUDA
events around 20 back-to-back calls (after one), in the order listed, then
reversed; it prints the card's name and power limit first and one JSON
object last, and exits non-zero without a CUDA device or on a variant that
is not bit for bit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
CSRC = ROOT / "src/repro_torch/kernels/csrc"
SOURCE = CSRC / "segment_sum.cu"
ENTRY = "repro_segment_sum"
# the entry before the redesign: ids, vals, order, out, n, n_out, width,
# skip, batch, dtype code, stream
PARENT_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 5 \
    + [ctypes.c_int, ctypes.c_void_p]


def constant(name: str, value: int) -> tuple:
    """An edit of the source setting ``constexpr int <name>`` to ``value``."""
    return (re.compile(rf"constexpr int {name} = \d+;"),
            f"constexpr int {name} = {value};")


def text(old: str, new: str) -> tuple:
    """An edit of the source replacing every ``old`` with ``new``."""
    return re.compile(re.escape(old)), new


# name: the source's edits
VARIANTS = {
    "source": [],
    "no_block": [constant("kLongRun", 0)],
    **{f"long_{n}": [constant("kLongRun", n)]
       for n in (64, 128, 256, 512, 2048)},
    "float32_adds": [text("bool HALF = sizeof(T) == 2>",
                          "bool HALF = false>")],
    "lanes_32": [text("while (lanes < 32 && lanes < nvec) lanes <<= 1;",
                      "lanes = 32;")],
    "batch_4": [constant("kVecBatch", 4)],
    "batch_16": [constant("kVecBatch", 16)],
    "stages_2": [constant("kStages", 2)],
}


def build(out_dir: pathlib.Path, parent) -> tuple:
    """Compile every variant with its own edits, and the parent's source
    where given (one nvcc each, all at once); return each one's library
    and each variant's kLongRun."""
    from repro_torch.kernels._build import FLAGS, _nvcc

    out_dir.mkdir(parents=True, exist_ok=True)
    sources, long_run = {}, {}
    for name, edits in VARIANTS.items():
        src = SOURCE.read_text()
        for pattern, new in edits:
            src, hits = pattern.subn(new, src)
            if not hits:
                raise RuntimeError(f"variant {name}: the source has changed")
        sources[name] = src
        long_run[name] = int(re.search(r"constexpr int kLongRun = (\d+);",
                                       src).group(1))
    if parent is not None:
        sources["parent"] = pathlib.Path(parent).read_text()
    procs = {}
    for name, src in sources.items():
        path = out_dir / f"{name}.cu"
        path.write_text(src.replace(f"{ENTRY}(", f"{ENTRY}_{name}("))
        procs[name] = subprocess.Popen(
            [_nvcc(), *FLAGS, "-shared", "-I", str(CSRC), str(path), "-o",
             str(out_dir / f"lib{name}.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    built = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name} failed to build:\n{out}")
        built[name] = out_dir / f"lib{name}.so"
    return built, long_run


def inputs(cs) -> dict:
    """name: (ids, values, n_out, order) on the card."""
    import numpy as np
    import torch

    from repro_torch.apps import gnn
    from repro_torch.apps.graphs import rmat_graph
    from repro_torch.kernels import segment_sum as ss
    from repro_torch.sparse import ops as sparse_ops

    g = rmat_graph(cs.GNN["nodes"], cs.GNN["avg_deg"], seed=0, device="cuda")
    a = gnn.normalize_adjacency(g)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(
        (cs.GNN["nodes"], cs.GNN["d"])).astype(np.float32)).cuda()
    ct = torch.from_numpy(rng.standard_normal(
        (cs.GNN["nodes"], cs.GNN["d"])).astype(np.float32)).cuda()
    with cs.recorded_sums(sparse_ops, ss) as calls:
        sparse_ops.csr_spmm(a, x.requires_grad_(), gather="aia").backward(ct)
    (ids, fwd, n_out, _, _), (gids, grad, g_out, order, _) = calls
    out = {"csr_spmm": (ids, fwd, n_out, None),
           "csr_spmm_dX": (gids, grad, g_out, order),
           "csr_spmm_bf16": (ids, fwd.bfloat16(), n_out, None),
           "csr_spmm_dX_bf16": (gids, grad.bfloat16(), g_out, order)}
    # the forward less its long runs: the tail's share
    _, counts = torch.unique_consecutive(ids, return_counts=True)
    keep = torch.repeat_interleave(counts <= ss.long_run(), counts)
    out["csr_spmm_no_long_runs"] = (ids[keep], fwd[keep].contiguous(), n_out,
                                    None)
    # the MoE gathers' backward at DeepSeek-V2-Lite's training shape
    tokens, k, d, e = 4096, 6, 2048, 64
    flat_e = torch.from_numpy(rng.integers(0, e, tokens * k)).cuda()
    t_sorted = torch.argsort(flat_e, stable=True) // k
    m_ids, m_order = torch.sort(t_sorted, stable=True)
    m_ct = torch.from_numpy(rng.standard_normal((tokens * k, d))
                            .astype(np.float32)).cuda().bfloat16()
    out["moe_backward"] = (m_ids, m_ct, tokens, m_order)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", help="the kernel's source before the "
                                         "W > 1 redesign, timed as 'parent'")
    parser.add_argument("--json", help="also write the results to this file")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("segment_sum_variants: no CUDA device is available",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import ops
    from repro_torch.kernels import segment_sum as ss
    from repro_torch.kernels._build import SIGNATURES

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    built, long_runs = build(ROOT / "build" / "segment_sum_variants",
                             args.parent)
    fns = {}
    for name, path in built.items():
        fn = getattr(ctypes.CDLL(str(path)), f"{ENTRY}_{name}")
        fn.argtypes = PARENT_ARGS if name == "parent" else SIGNATURES[ENTRY]
        fn.restype = ctypes.c_int
        fns[name] = fn
    cases = inputs(cs)

    def caller(name, ids, values, n_out, order):
        fn = fns[name]
        n, width = values.shape
        work = torch.empty(ss.work_len(n, n_out, width,
                                       long_runs.get(name, 0)),
                           dtype=torch.int64, device="cuda")
        optr = None if order is None else order.data_ptr()

        def call():
            out = torch.empty((n_out, width), dtype=values.dtype,
                              device="cuda")
            stream = torch.cuda.current_stream().cuda_stream
            code = ops.DTYPE_CODES[values.dtype]
            if name == "parent":
                rc = fn(ids.data_ptr(), values.data_ptr(), optr,
                        out.data_ptr(), n, n_out, width, 0, 1, code, stream)
            else:
                rc = fn(ids.data_ptr(), values.data_ptr(), optr,
                        out.data_ptr(), work.data_ptr(), n, n_out, width, 0,
                        1, code, stream)
            if rc:
                raise RuntimeError(f"{name}: launch failed: error {rc}")
            return out
        return call

    names = list(VARIANTS) + (["parent"] if args.parent else [])
    results, ok = {}, True
    for case, (ids, values, n_out, order) in cases.items():
        want = ss.segment_sum_plain(ids.cpu(), values.cpu(), n_out,
                                    None if order is None else order.cpu())
        calls = {name: caller(name, ids, values, n_out, order)
                 for name in names}
        exact = {}
        for name, call in calls.items():
            got = call()
            again = call()
            exact[name] = bool(torch.equal(got.cpu(), want)
                               and torch.equal(got, again))
            ok &= exact[name]
        times = {name: [] for name in names}
        for name in names + names[::-1]:
            times[name].append(cs.loop_ms(calls[name], reps=20))
        summed = int(((ids >= 0) & (ids < n_out)).sum())
        nbytes = ids.numel() * 8 + (0 if order is None else summed * 8) \
            + (summed + n_out) * values.shape[1] * values.element_size()
        _, counts = torch.unique_consecutive(ids, return_counts=True)
        results[case] = {
            "n": ids.numel(), "n_out": n_out, "width": values.shape[1],
            "dtype": str(values.dtype), "order": order is not None,
            "longest_run": int(counts.max()),
            "runs_past_long_run": int((counts > ss.long_run()).sum()),
            "bound_ms": cs.bound_ms(nbytes),
            "loop_ms": times, "bit_exact": exact,
            "segment_reduce_loop_ms": cs.loop_ms(
                lambda: torch.segment_reduce(
                    values if order is None else values.index_select(0, order),
                    "sum", lengths=torch.bincount(ids, minlength=n_out)),
                reps=20)}
        print(json.dumps({case: results[case]}), flush=True)
    record = {"nvidia_smi": smi, "long_run": ss.long_run(),
              "cases": results}
    if args.json:
        pathlib.Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.json).write_text(json.dumps(record, indent=1))
    print(json.dumps(record), flush=True)
    if not ok:
        print("segment_sum_variants: a variant is not bit for bit",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
