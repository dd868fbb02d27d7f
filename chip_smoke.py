#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's SpGEMM path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--json PATH]

Run from the root of a checkout, on a machine with one CUDA card.  It

1. prints the card's name and power limit as ``nvidia-smi`` gives them;
2. builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` (``nvcc``,
   ``sm_90a``) and prints the build time and ``ptxas``'s report;
3. holds each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it, for exact equality, and times both
   (CUDA events around the call, and the kernels' own device time from
   ``torch.profiler``): K1 (the AIA row gather) on the first chunk of
   every Table-I group of RoadTX and p2p-Gnutella04, both ELL planes, and
   timed on the RoadTX group-0 chunk beside ``torch.index_select``; K2
   (Algorithm 4's hash accumulate) on the same chunks, compared where the
   stream is at most 16,384 long; each kernel's bound counts the bytes this
   run's data needs (distinct source rows, real products);
4. runs the self-products of RoadTX (1,393,383 rows) and p2p-Gnutella04
   (10,876 rows), seed 0, through ``spgemm(a, a)`` (sort engine, AIA
   gather, measured sizing), ``spgemm(a, a, engine="fused_hash")`` (AIA
   gather, planned sizing: both kernels, no host sync in the pipeline) and
   ``engine="hash", gather="xla"``; checks each product against
   ``scipy.sparse`` (structure exact, values within rtol 1e-4 / atol 1e-6:
   float32 sums in another order than scipy's float64), the hash path
   bit-identical to hash/xla, zero pipeline syncs on the planned call and
   the kernels' launch counts; profiles one more run of each call (device
   time, busy share, top kernels); and times ``torch.sparse.mm``
   (cuSPARSE) on the same CSR as a yardstick the port never calls;
5. prints the kernels' JSON line, then ``{"ok": true, "device": ...}`` last.

Every check raises on failure, so the script exits non-zero; it also exits
non-zero, printing no result, when no CUDA device is available.  ``--json``
writes every number it printed to PATH as well.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
MATRICES = {"RoadTX": 1_393_383, "p2p-Gnutella04": 10_876}
K2_MAX_STREAM = 16_384  # the lockstep plain version is too slow beyond this
RTOL, ATOL = 1e-4, 1e-6


def emit(record: dict, log: list) -> None:
    log.append(record)
    print(json.dumps(record), flush=True)


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after ``warmup``."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _self_device_us(event) -> float:
    return getattr(event, "self_device_time_total", None) \
        or getattr(event, "self_cuda_time_total", 0.0)


def profile(fn):
    """(host ms, device ms, [(kernel, device ms)] by time) of one call of
    ``fn``, from ``torch.profiler``; device ms is None when the profiler
    recorded no device time."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    # device events only: their self time is the kernels' and copies' own
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) is not None
              and "CUDA" in str(e.device_type) and _self_device_us(e) > 0]
    device_us = sum(_self_device_us(e) for e in events)
    top = sorted(events, key=_self_device_us, reverse=True)[:6]
    return host_ms, (device_us / 1e3 if device_us else None), \
        [(e.key[:80], _self_device_us(e) / 1e3, e.count) for e in top]


def device_ms(fn, reps: int = 10):
    """Device time per call of ``fn``'s kernels, from ``torch.profiler``
    (None when the profiler recorded none)."""
    fn()
    _, dev, _ = profile(lambda: [fn() for _ in range(reps)])
    return None if dev is None else dev / reps


def bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# Phase 3: each kernel against its plain version, at the main path's shapes
# ---------------------------------------------------------------------------

def chunk_operands(a):
    """The plan's first chunk of every Table-I group, with B's ELL."""
    import torch

    from repro_torch.core import executor as ex
    from repro_torch.core.grouping import group_rows
    from repro_torch.sparse.formats import csr_to_ell

    plan = group_rows(a, a)
    indptr = a.indptr.cpu().numpy().astype(np.int64)
    row_nnz = np.diff(indptr)
    kb_cap = int(row_nnz.max())
    ell = csr_to_ell(a, kb_cap)
    items = ex.partition_plan(plan, row_nnz, 4096)
    _, rows = ex._chunk_rows(items, a.device)
    firsts = {}
    for item, r in zip(items, rows):
        firsts.setdefault(item.group, (item, r))
    torch.cuda.synchronize()
    return ell, firsts


def kernel_phase(mats, log):
    from repro_torch.core import phases
    from repro_torch.kernels import aia_gather, hash_accum

    k1 = k2 = None
    for name, a in mats.items():
        ell, firsts = chunk_operands(a)
        for g, (item, rows) in sorted(firsts.items()):
            cols_a, vals_a = phases.gather_group_rows(
                a.indptr, a.indices, a.data, rows, item.a_cap)
            flat = cols_a.reshape(-1)
            main = name == "RoadTX" and g == 0
            rec = gather_check(name, g, ell, flat, aia_gather, log,
                               timed=main)
            if main:
                k1 = rec
            keys, vals = phases.enumerate_products(cols_a, vals_a,
                                                   ell.indices, ell.data)
            rec = hash_check(name, g, keys, vals, item.table_cap, hash_accum,
                             log, compare=keys.shape[1] <= K2_MAX_STREAM)
            if main:
                k2 = rec
    check(k1 is not None and k2 is not None, "RoadTX group 0 chunk missing")
    return k1, k2


def gather_check(name, g, ell, flat, aia_gather, log, timed=False):
    """Hold K1 against its plain version on one chunk's id stream, both
    ELL planes; with ``timed``, also time it beside the plain version and
    ``index_select``."""
    import torch

    planes = (ell.indices, ell.data)
    got = [aia_gather.gather_rows(x, flat) for x in planes]
    want = [aia_gather.gather_rows_plain(x, flat) for x in planes]
    torch.cuda.synchronize()
    for gp, wp in zip(got, want):
        check(torch.equal(gp, wp), f"K1 differs from its plain version "
                                   f"({name} group {g})")
    n_x, kb = ell.indices.shape
    safe = flat.clamp(0, n_x - 1).long()
    n = flat.shape[0]
    rec = {"matrix": name, "group": g, "n_idx": n, "row_words": kb,
           "max_abs_err": max(float((gp.double() - wp.double()).abs().max())
                              for gp, wp in zip(got, want))}
    if not timed:
        emit({"k1_check": rec}, log)
        return rec
    # Per plane, each distinct (clipped) source row read once and every
    # output row written once; the ids read once.
    distinct = int(torch.unique(safe).numel())
    rec["distinct_rows"] = distinct

    def kernel():
        return [aia_gather.gather_rows(x, flat) for x in planes]

    def plain():
        return [aia_gather.gather_rows_plain(x, flat) for x in planes]

    def library():
        return [torch.index_select(x, 0, safe) for x in planes]

    rec.update({
        "ms": time_ms(kernel, reps=20),
        "plain_ms": time_ms(plain, reps=20),
        "library_ms": time_ms(library, reps=20),
        "device_ms": device_ms(kernel),
        "plain_device_ms": device_ms(plain),
        "library_device_ms": device_ms(library),
        "bound_ms": bound_ms(2 * (distinct + n) * kb * 4 + n * 4),
    })
    emit({"k1_chunk": rec}, log)
    return rec


def hash_check(name, g, keys, vals, table_cap, hash_accum, log,
               compare=True):
    """Time K2 on one chunk; with ``compare``, first hold it against the
    plain version (too slow beyond ``K2_MAX_STREAM`` stream slots)."""
    import torch

    r, ip_cap = keys.shape
    rec = {"matrix": name, "group": g, "rows": r, "ip_cap": ip_cap,
           "table_cap": table_cap, "compared": compare}
    if compare:
        got = hash_accum.hash_accumulate(keys, vals, table_cap)
        t0 = time.perf_counter()
        want = hash_accum.hash_accumulate_plain(keys, vals, table_cap)
        torch.cuda.synchronize()
        rec["plain_ms"] = (time.perf_counter() - t0) * 1e3
        for part, gp, wp in zip(("cols", "vals", "cnt"), got, want):
            check(torch.equal(gp, wp), f"K2 {part} differ from the plain "
                                       f"version ({name} group {g})")
        rec["max_abs_err"] = float((got[1] - want[1]).abs().max())

    def kernel():
        return hash_accum.hash_accumulate(keys, vals, table_cap)

    rec["ms"] = time_ms(kernel, reps=10 if compare else 3)
    rec["device_ms"] = device_ms(kernel, reps=10 if compare else 3)
    # Every key read once, a value only where its key is a product (the
    # kernel skips the value of a padding key), the tables and the counts
    # written once.
    products = int((keys >= 0).sum())
    rec["products"] = products
    rec["bound_ms"] = bound_ms(r * ip_cap * 4 + products * 4
                               + r * table_cap * 8 + r * 4)
    emit({"k2_chunk": rec}, log)
    return rec


# ---------------------------------------------------------------------------
# Phase 4: the port's main path end to end
# ---------------------------------------------------------------------------

CALLS = (
    ("default", {}, {"gather_rows"}, 1),
    ("fused_hash", {"engine": "fused_hash"},
     {"gather_rows", "hash_accumulate"}, 0),
    ("hash_xla", {"engine": "hash", "gather": "xla"}, {"hash_accumulate"}, 1),
)


def scipy_product(a):
    import scipy.sparse as sp

    n = a.n_rows
    host = sp.csr_matrix((a.data.cpu().numpy().astype(np.float64),
                          a.indices.cpu().numpy(), a.indptr.cpu().numpy()),
                         shape=(n, n))
    c = (host @ host).tocsr()
    c.sort_indices()
    return c


def check_against_scipy(name, label, c, nnz, want):
    indptr = c.indptr.cpu().numpy()
    check(nnz == want.nnz, f"{name}/{label}: nnz {nnz} != scipy {want.nnz}")
    check(np.array_equal(indptr, want.indptr), f"{name}/{label}: indptr")
    check(np.array_equal(c.indices[:nnz].cpu().numpy(), want.indices),
          f"{name}/{label}: indices")
    got = c.data[:nnz].cpu().numpy().astype(np.float64)
    check(np.allclose(got, want.data, rtol=RTOL, atol=ATOL),
          f"{name}/{label}: values beyond rtol {RTOL} atol {ATOL}")
    return float(np.abs(got - want.data).max(initial=0.0))


def run_call(a, kwargs, count_syncs=False):
    import torch

    from repro_torch.core import executor
    from repro_torch.core.spgemm import spgemm
    from repro_torch.kernels import ops

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    executor.clear_program_cache()
    before = ops.launch_counts()
    syncs = None
    t0 = time.perf_counter()
    if count_syncs:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                res = spgemm(a, a, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs = [f"{pathlib.Path(w.filename).name}:{w.lineno}" for w in caught
                 if "synchroniz" in str(w.message).lower()]
    else:
        res = spgemm(a, a, **kwargs)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    after = ops.launch_counts()
    return res, ms, {k: after[k] - before[k] for k in after}, \
        executor.cache_stats()["host_sync_count"], syncs


def cusparse_ms(a):
    import torch

    nnz = int(a.nnz)
    with warnings.catch_warnings():  # "sparse CSR support is in beta"
        warnings.simplefilter("ignore")
        t = torch.sparse_csr_tensor(a.indptr, a.indices[:nnz], a.data[:nnz],
                                    size=a.shape, check_invariants=False)
        return (time_ms(lambda: torch.sparse.mm(t, t), reps=3),
                device_ms(lambda: torch.sparse.mm(t, t), reps=3))


def end_to_end_phase(mats, log):
    import torch

    from repro_torch.core.spgemm import spgemm
    from repro_torch.kernels import ops

    ops.reset_launch_counts()  # the main path's count starts here
    per_call = {}
    for name, a in mats.items():
        want = scipy_product(a)
        results = {}
        for label, kwargs, kernels, syncs_expected in CALLS:
            planned = label == "fused_hash"
            res, cold_ms, launches, syncs, debug_syncs = run_call(
                a, kwargs, count_syncs=planned)
            nnz = res.info["nnz_c"]
            err = check_against_scipy(name, label, res.c, nnz, want)
            check(syncs == syncs_expected,
                  f"{name}/{label}: host_sync_count {syncs}, expected "
                  f"{syncs_expected}")
            for k, n in launches.items():
                check((n > 0) == (k in kernels),
                      f"{name}/{label}: {k} launched {n} times")
            _, ms, _, _, _ = run_call(a, kwargs)
            results[label] = res
            per_call[f"{name}/{label}"] = launches
            rec = {"matrix": name, "call": label, "rows": a.n_rows,
                   "nnz_a": res.info["nnz_a"], "nnz_c": nnz,
                   "intermediate_products": res.info["intermediate_products"],
                   "group_sizes": res.info["group_sizes"],
                   "ms": ms, "cold_ms": cold_ms, "host_sync_count": syncs,
                   "launches": launches, "max_abs_err_vs_scipy": err,
                   "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
            if planned:
                rec["sync_debug_warnings"] = len(debug_syncs)
                rec["sync_debug_sites"] = debug_syncs
            host_ms, dev_ms, top = profile(lambda: spgemm(a, a, **kwargs))
            rec["profiled"] = {"host_ms": host_ms, "device_ms": dev_ms,
                               "device_busy_share": None if dev_ms is None
                               else dev_ms / host_ms, "top_kernels": top}
            emit({"e2e": rec}, log)
        fu, hx = results["fused_hash"].c, results["hash_xla"].c
        nnz = results["hash_xla"].info["nnz_c"]
        check(torch.equal(fu.indptr, hx.indptr)
              and torch.equal(fu.indices[:nnz], hx.indices[:nnz])
              and torch.equal(fu.data[:nnz], hx.data[:nnz]),
              f"{name}: fused_hash/aia is not bit-identical to hash/xla")
        ms, dev_ms = cusparse_ms(a)
        emit({"cusparse": {"matrix": name, "ms": ms, "device_ms": dev_ms}},
             log)
    totals = ops.launch_counts()
    for k, n in totals.items():
        check(n > 0, f"kernel {k} was never launched on the main path")
    return totals, per_call


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--json", help="also write every record to this file")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.apps.graphs import table_ii_matrix
    from repro_torch.kernels import _build

    log: list = []
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in (lib_path.parent / "build.log")
             .read_text().splitlines() if "ptxas info" in ln]
    emit({"build": {"seconds": build_s, "library": str(lib_path),
                    "ptxas": ptxas}}, log)

    mats = {name: table_ii_matrix(name, seed=0, n_override=n, device="cuda")
            for name, n in MATRICES.items()}
    k1, k2 = kernel_phase(mats, log)
    totals, per_call = end_to_end_phase(mats, log)

    kernels = [
        {"name": "aia_gather_rows", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/aia_gather.cu",
         "replaces": "src/repro/kernels/aia_gather.py:75",
         "tpu_kernel": "src/repro/kernels/aia_gather.py:gather_rows",
         "shape": {"planes": 2, **{k: k1[k] for k in (
             "matrix", "group", "n_idx", "row_words")}},
         "launches": totals["gather_rows"],
         "launches_per_spgemm": {c: n["gather_rows"]
                                 for c, n in per_call.items()},
         "max_abs_err": k1["max_abs_err"], "ms": k1["ms"],
         "kernel_ms": k1["ms"], "device_ms": k1["device_ms"],
         "plain_ms": k1["plain_ms"],
         "bound_ms": k1["bound_ms"], "bound_by": "bytes",
         "library_ms": k1["library_ms"]},
        {"name": "hash_accumulate", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/hash_accum.cu",
         "replaces": "src/repro/kernels/hash_accum.py:130",
         "tpu_kernel": "src/repro/kernels/hash_accum.py:hash_accumulate",
         "shape": {k: k2[k] for k in ("matrix", "group", "rows", "ip_cap",
                                      "table_cap")},
         "launches": totals["hash_accumulate"],
         "launches_per_spgemm": {c: n["hash_accumulate"]
                                 for c, n in per_call.items()},
         "max_abs_err": k2["max_abs_err"], "ms": k2["ms"],
         "kernel_ms": k2["ms"], "device_ms": k2["device_ms"],
         "plain_ms": k2["plain_ms"],
         "bound_ms": k2["bound_ms"], "bound_by": "bytes",
         "library_ms": None},
    ]
    emit({"kernels": kernels}, log)
    if args.json:
        pathlib.Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.json).write_text(json.dumps(
            {"nvidia_smi": smi, "records": log}, indent=1))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
