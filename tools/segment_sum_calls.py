#!/usr/bin/env python3
"""Time every segment-sum call of the default lane on one CUDA card.

    python3 tools/segment_sum_calls.py [--json PATH]

Run from the root of a checkout.  It runs the RoadTX and p2p-Gnutella04
self-products (``spgemm(a, a)``, seed 0, paper size) and MCL on Economics
(206,500 rows, bench_mcl's parameters cut to 2 iterations, as
``chip_smoke.py`` runs them) on the default lane, with each call of the
segment-sum kernel (``kernels.segment_sum``) synchronised and timed on the
host's clock alone, and records its shape: entries, segments, columns,
the permuted route, ``skip``, the runs it sums and the longest of them.
It prints the card's name and power limit first, then a JSON object a
workload (the calls' count and total ms, and the ten longest calls), the
last line holding them all.  It exits non-zero without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
MATRICES = {"RoadTX": 1_393_383, "p2p-Gnutella04": 10_876}
MCL = ("Economics", 206_500)
MCL_ARGS = {"e": 2, "r": 2.0, "theta": 1e-4, "k": 32, "tol": 0.0,
            "max_iters": 2}


def timed_calls(ss, calls):
    """Wrap ``ss._segment_sum_cuda`` so that each call is timed alone and
    appended to ``calls``; returns the original."""
    import torch

    real = ss._segment_sum_cuda

    def timed(ids, values, n_out, order=None, skip=0):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(ids, values, n_out, order, skip)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        seg, counts = torch.unique_consecutive(ids, return_counts=True)
        kept = seg < n_out
        if skip:
            kept &= seg % skip != skip - 1
        calls.append({"ms": ms, "n": ids.numel(), "n_out": n_out,
                      "width": values.shape[-1], "order": order is not None,
                      "skip": skip, "runs": int(kept.sum()),
                      "longest_run": int(counts[kept].max())
                      if kept.any() else 0})
        return out

    ss._segment_sum_cuda = timed
    return real


def summary(name, calls) -> dict:
    return {"workload": name, "calls": len(calls),
            "total_ms": sum(c["ms"] for c in calls),
            "longest": sorted(calls, key=lambda c: -c["ms"])[:10]}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--json", help="also write the records to PATH")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("segment_sum_calls: no CUDA device is available",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.apps.graphs import table_ii_matrix
    from repro_torch.apps.markov_clustering import mcl
    from repro_torch.core.spgemm import spgemm
    from repro_torch.kernels import _build
    from repro_torch.kernels import segment_sum as ss

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip(),
          flush=True)
    _build.library()
    calls: list = []
    real = timed_calls(ss, calls)
    out = []
    try:
        for name, n in MATRICES.items():
            a = table_ii_matrix(name, seed=0, n_override=n, device="cuda")
            spgemm(a, a)  # warm-up
            calls.clear()
            spgemm(a, a)
            out.append(summary(f"{name} product", calls))
            print(json.dumps(out[-1]), flush=True)
            del a
        name, n = MCL
        g = table_ii_matrix(name, seed=0, n_override=n, device="cuda")
        calls.clear()
        mcl(g, **MCL_ARGS)
        out.append(summary(f"MCL {name}", calls))
        print(json.dumps(out[-1]), flush=True)
    finally:
        ss._segment_sum_cuda = real
    if args.json:
        pathlib.Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.json).write_text(json.dumps(out, indent=1))
    print(json.dumps({"workloads": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
