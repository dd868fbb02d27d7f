#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py [--json PATH]

Run from the root of a checkout, on a machine with one CUDA card.  Float32
products run in full float32 (TF32 off).  It

1. prints the card's name and power limit as ``nvidia-smi`` gives them;
2. builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` (``nvcc``,
   ``sm_90a``) and prints the build time and ``ptxas``'s report;
3. drives the sparse-activation path of ``kernels.ops`` at the FFN width
   of Phi-3-mini (``phi3_mini_3_8b``: d_model 3072, d_ff 8192, bf16; 2,048
   tokens, TopK k = d_ff/8 = 1,024, blocks of 128 lanes, tiles of 8 tokens;
   random weights from seed 0), with the launch counts set to 0 before and
   read after: ``topk_rows -> ops.topk_spmm`` (K5), the per-tile block
   selection of ``block_topk_ffn`` -> ``ops.block_topk_spmm`` (K6) and
   ``ops.aia_ranged_gather`` of the selected W2 blocks (K3, 1.61 GB), and a
   3-of-24 block-pruned W1^T as a BSR (``bsr_from_dense``) times x^T through
   ``ops.bsr_spmm`` (K4); checks the results (finite, shaped, K5 against
   ``topk_rows_st(h, k) @ W2``, K6 against K3's blocks times h, K4 against
   the dense product, each within 1e-5 of the largest |value|), with K3 on
   its 16-byte route and K4 and K6 on their bf16 ``wgmma`` kernels
   (``FFN_ROUTES``); holds each kernel against its plain version (K3 and
   K5 bit-exact, K4 and K6 within 1e-5 of the largest |value|) on a sweep
   of the CPU tests' shapes in float32 and bf16, on both of K3's routes
   (``RANGED_ROUTES``), on K4's tile edges (``BSR_EDGES``) and on K6's
   edges (``K6_EDGES``: repeated, clipped and unpicked ids, tile 1, a block
   every tile picks, odd widths), then on the path's own inputs,
   where each call must add exactly one launch; and times kernel (CUDA
   events; device time of its own launches from ``torch.profiler``),
   plain version and one
   library call that computes the same function (``index_select``,
   ``torch.sparse_bsr_tensor @ b``, ``F.embedding_bag``, ``torch.bmm`` on
   pre-gathered blocks), with the dense bf16 ``torch.matmul`` of the whole
   down-projection beside them, and K3's, K4's and K6's routes and
   ``ptxas`` registers, spills and shared memory;
4. holds K7 (``ops.flash_attention_fused``) against its plain version on
   the 12 cases of ``tests/test_flash_kernel.py`` (float32 and bf16, causal
   and not), on the edges of the bf16 kernel's tiles (D 7, 36, 40, 96 and
   128 at S 64 and 192, causal and not, blocks of 64), the float32 kernel
   at the decode check's shape (32 heads, S 512, D 96), then at Phi-3-mini's
   prefill shape (BH 64 = batch 2 x 32 heads, S 4,096, D 96, bf16,
   causal), one launch per call; float32 within 1e-5 + 1e-5 relative, bf16
   within one bf16 step (2**-7 relative); and times it there (CUDA events;
   device time from ``torch.profiler``) beside its bound (operations), its
   plain version and ``F.scaled_dot_product_attention`` (a yardstick the
   port never calls), with its route (bf16: ``wgmma``), its rate, and
   ``ptxas``'s registers and spills and its shared memory; then holds and
   times the float32 route (CUDA cores) at the same shape in float32;
5. drives the LM path of Phi-3-mini (``phi3_mini_3_8b``) at full width and
   depth (32 layers, bf16, random weights from seed 0), each part with the
   launch counts from 0: ``models.transformer.train_loss`` forward-only on
   2 x 4,096 tokens (the loss within [-1, +2] of ln(vocab), 32 K7 launches);
   a ``serve.ServeEngine`` answering 4 requests of 4-6 prompt tokens x 8
   new tokens; then, in float32 at 4 layers, ``decode_step`` fed a 512-token
   prompt token by token against the prefill forward's last-position
   logits (within 1e-4 of the largest |logit|);
6. holds K1 and K2 against their plain PyTorch versions on the card, at
   the shapes the SpGEMM path gives them, for exact equality, and times both
   (CUDA events around the call, and the kernels' own device time from
   ``torch.profiler``): K1 (the AIA row gather) on the first chunk of
   every Table-I group of RoadTX and p2p-Gnutella04, both ELL planes, and
   timed on the RoadTX group-0 chunk beside ``torch.index_select``; K2
   (Algorithm 4's hash accumulate) on the same chunks, each on the route
   its table size chooses (groups 0-2: ``"smem"``, group 3: ``"global"``)
   and held bit for bit, a stream wider than 16,384 slots on its products
   packed to the front (the same tables); each kernel's bound counts the
   bytes this run's data needs (distinct source rows, real products);
7. runs the self-products of RoadTX (1,393,383 rows) and p2p-Gnutella04
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
8. prints the kernels' JSON line, then ``{"ok": true, "device": ...}`` last.

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
# Peak dense rates of one H100 SXM by operand type (NVIDIA's data sheet):
# bf16 on the tensor cores, float32 on the CUDA cores.
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12}
# Phi-3-mini's FFN (src/repro/configs/phi3_mini_3_8b.py, bf16 per
# configs/base.py): 2,048 tokens = batch 8 x seq 256 (launch/train.py:4),
# k = d_ff // 8 (launch/train.py:44), blocks of 128 lanes
# (configs/base.py:57), tiles of 8 tokens (models/ffn.py:62); the BSR keeps
# 3 of 24 block-columns per block-row, the same eighth.
FFN = {"d_model": 3072, "d_ff": 8192, "tokens": 2048, "k": 1024,
       "block": 128, "tile": 8, "bsr_keep": 3}
FFN_REL = 1e-5  # float32 sums in another order, bf16 products exact


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
# Phase 6: K1 and K2 against their plain versions, at the SpGEMM path's shapes
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
    chunks = []
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
                             log)
            chunks.append({k: rec[k] for k in (
                "matrix", "group", "rows", "ip_cap", "table_cap", "route",
                "compared", "device_ms", "bound_ms")})
            if main:
                k2 = rec
    check(k1 is not None and k2 is not None, "RoadTX group 0 chunk missing")
    k2["chunks"] = chunks
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


def packed_stream(keys, vals):
    """Each row's products moved to the front of its stream in stream order
    (a stable pack), cut to the longest row's count.  Algorithm 4 skips
    padding, so the packed stream gives the same tables."""
    import torch

    valid = keys >= 0
    width = int(valid.sum(1).max()) if keys.numel() else 0
    order = torch.argsort((~valid).to(torch.int8), dim=1,
                          stable=True)[:, :width]
    return keys.gather(1, order), vals.gather(1, order)


def hash_check(name, g, keys, vals, table_cap, hash_accum, log):
    """Hold K2 bit for bit against the plain version on one chunk, then
    time it.  A chunk whose stream is wider than ``K2_MAX_STREAM`` slots
    (the plain version's reach) is held on its packed stream
    (``"packed"``); a packed stream still too wide, on its rows of at most
    ``K2_MAX_STREAM`` products (``"rows"``).  The chunk must take the route
    its table size chooses: shared memory for Table-I groups 0-2, global
    memory for group 3."""
    import torch

    from repro_torch.kernels import ops

    r, ip_cap = keys.shape
    route = hash_accum.route(table_cap)
    check(route == ("global" if g == 3 else "smem"),
          f"K2 {name} group {g}: {table_cap}-slot tables take {route}")
    rec = {"matrix": name, "group": g, "rows": r, "ip_cap": ip_cap,
           "table_cap": table_cap, "route": route}
    before = ops.route_counts().get(f"hash_accumulate/{route}", 0)
    got = hash_accum.hash_accumulate(keys, vals, table_cap)
    check(ops.route_counts().get(f"hash_accumulate/{route}", 0) == before + 1,
          f"K2 {name} group {g}: the call did not take the {route} route")
    held_k, held_v, rows = keys, vals, slice(None)
    rec["compared"] = "full"
    if ip_cap > K2_MAX_STREAM:
        held_k, held_v = packed_stream(keys, vals)
        rec["compared"], rec["packed_width"] = "packed", held_k.shape[1]
        if held_k.shape[1] > K2_MAX_STREAM:
            rows = ((held_k >= 0).sum(1) <= K2_MAX_STREAM).nonzero()[:, 0]
            held_k = held_k[rows, :K2_MAX_STREAM].contiguous()
            held_v = held_v[rows, :K2_MAX_STREAM].contiguous()
            rec["compared"], rec["rows_held"] = "rows", int(rows.numel())
    t0 = time.perf_counter()
    want = hash_accum.hash_accumulate_plain(held_k, held_v, table_cap)
    torch.cuda.synchronize()
    rec["plain_ms"] = (time.perf_counter() - t0) * 1e3
    for part, gp, wp in zip(("cols", "vals", "cnt"), got, want):
        check(torch.equal(gp[rows], wp), f"K2 {part} differ from the plain "
                                         f"version ({name} group {g})")
    rec["max_abs_err"] = float((got[1][rows] - want[1]).abs().max())

    def kernel():
        return hash_accum.hash_accumulate(keys, vals, table_cap)

    rec["ms"] = time_ms(kernel, reps=10)
    # device time per call (the window-mask and insert kernels), and each
    # kernel's own share
    kernel()
    _, dev, top = profile(lambda: [kernel() for _ in range(10)])
    rec["device_ms"] = None if dev is None else dev / 10
    rec["device_kernels"] = [(k, ms / 10) for k, ms, _ in top]
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
# Phase 7: the SpGEMM path end to end
# ---------------------------------------------------------------------------

SPGEMM_KERNELS = ("gather_rows", "hash_accumulate")
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
    routes_before = ops.route_counts()
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
    routes = {k: n - routes_before.get(k, 0)
              for k, n in ops.route_counts().items()
              if n != routes_before.get(k, 0)}
    return res, ms, {k: after[k] - before[k] for k in after}, routes, \
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
            res, cold_ms, launches, routes, syncs, debug_syncs = run_call(
                a, kwargs, count_syncs=planned)
            nnz = res.info["nnz_c"]
            err = check_against_scipy(name, label, res.c, nnz, want)
            check(syncs == syncs_expected,
                  f"{name}/{label}: host_sync_count {syncs}, expected "
                  f"{syncs_expected}")
            for k, n in launches.items():
                check((n > 0) == (k in kernels),
                      f"{name}/{label}: {k} launched {n} times")
            _, ms, _, _, _, _ = run_call(a, kwargs)
            results[label] = res
            per_call[f"{name}/{label}"] = launches
            rec = {"matrix": name, "call": label, "rows": a.n_rows,
                   "nnz_a": res.info["nnz_a"], "nnz_c": nnz,
                   "intermediate_products": res.info["intermediate_products"],
                   "group_sizes": res.info["group_sizes"],
                   "ms": ms, "cold_ms": cold_ms, "host_sync_count": syncs,
                   "launches": launches, "route_launches": routes,
                   "max_abs_err_vs_scipy": err,
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
    for k in SPGEMM_KERNELS:
        check(totals[k] > 0, f"kernel {k} was never launched on the main path")
    return totals, per_call


# ---------------------------------------------------------------------------
# Phase 3: the sparse-activation path (K3-K6) at Phi-3-mini FFN width
# ---------------------------------------------------------------------------

def rel_err(got, want) -> float:
    """max |got - want| over the largest |want|, in float64."""
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-300))


def ffn_operands(seed: int = 0):
    """x (tokens, d_model), W1 and W2, h = silu(x W1) * (x W3), all bf16,
    from a seeded generator on the card."""
    import torch
    import torch.nn.functional as F

    d, f, n = FFN["d_model"], FFN["d_ff"], FFN["tokens"]
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * scale).to(
            torch.bfloat16)

    x = rand(n, d)
    w1, w3 = rand(d, f, scale=d ** -0.5), rand(d, f, scale=d ** -0.5)
    w2 = rand(f, d, scale=f ** -0.5)
    h = F.silu(x @ w1) * (x @ w3)
    return x, w1, w2, h


def pruned_bsr(w, keep, block):
    """``w`` with all but its ``keep`` highest-energy blocks per block-row
    zeroed, as a BSR through ``bsr_from_dense``."""
    import torch

    from repro_torch.sparse.formats import bsr_from_dense
    from repro_torch.sparse.topk import topk_mask

    r, c = w.shape
    nbr, nbc = r // block, c // block
    energy = w.float().reshape(nbr, block, nbc, block).square().sum((1, 3))
    mask = topk_mask(energy, keep)
    dense_mask = mask.repeat_interleave(block, 0).repeat_interleave(block, 1)
    return bsr_from_dense(torch.where(dense_mask, w, 0), (block, block),
                          device=w.device)


def ffn_path(x, w1, w2, h):
    """The path a user of ``kernels.ops`` drives: K5 on the TopK rows of h,
    K6 and K3 on the per-tile block selection, K4 on the pruned W1^T."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models.ffn import tile_block_select
    from repro_torch.sparse.topk import topk_rows

    k, block, tile = FFN["k"], FFN["block"], FFN["tile"]
    tk = topk_rows(h, k)
    y5 = ops.topk_spmm(tk.values, tk.indices, w2)
    h_kept, bidx = tile_block_select(h, k // block, block, tile)
    y6 = ops.block_topk_spmm(h_kept, bidx, w2, block)
    w2_sel = ops.aia_ranged_gather(w2, bidx.reshape(-1), block)
    bsr = pruned_bsr(w1.t().contiguous(), FFN["bsr_keep"], block)
    xt = x.t().contiguous()
    y4 = ops.bsr_spmm(bsr.indptr, bsr.indices, bsr.blocks, xt,
                      FFN["bsr_keep"])
    torch.cuda.synchronize()
    return {"tk": tk, "y5": y5, "h_kept": h_kept, "bidx": bidx, "y6": y6,
            "w2_sel": w2_sel, "bsr": bsr, "xt": xt, "y4": y4}


def check_ffn_outputs(out, h, w2):
    """The path's results, held against dense products on the same data."""
    import torch

    from repro_torch.core.spgemm_bsr import bsr_spgemm_dense_rhs
    from repro_torch.sparse.formats import bsr_to_dense
    from repro_torch.sparse.topk import topk_rows_st

    n, d, f = FFN["tokens"], FFN["d_model"], FFN["d_ff"]
    block, tile = FFN["block"], FFN["tile"]
    nt, kb = n // tile, FFN["k"] // block
    shapes = {"y5": (n, d), "y6": (n, d), "w2_sel": (nt * kb * block, d),
              "y4": (f, n)}
    for name, shape in shapes.items():
        t = out[name]
        check(tuple(t.shape) == shape, f"{name}: shape {tuple(t.shape)}")
        check(bool(torch.isfinite(t).all()), f"{name}: non-finite values")
    errs = {}
    # topk_ffn's last line, ffn.py:58-59: the masked h times W2, dense
    dense5 = topk_rows_st(h.float(), FFN["k"]) @ w2.float()
    errs["topk_spmm_vs_masked_dense"] = rel_err(out["y5"], dense5)
    del dense5
    # block_topk_ffn's einsum on K3's gathered W2 blocks
    hk = out["h_kept"].permute(0, 2, 1, 3).reshape(nt, tile, kb * block)
    y3 = torch.bmm(hk.float(),
                   out["w2_sel"].view(nt, kb * block, d).float())
    errs["block_topk_spmm_vs_ranged_gather_bmm"] = rel_err(
        out["y6"], y3.reshape(n, d))
    del y3
    bsr = out["bsr"]
    dense4 = bsr_to_dense(bsr).float() @ out["xt"].float()
    errs["bsr_spmm_vs_dense"] = rel_err(out["y4"], dense4)
    del dense4
    errs["bsr_spmm_vs_spgemm_bsr_bf16"] = rel_err(
        out["y4"], bsr_spgemm_dense_rhs(bsr, out["xt"]))
    for name, e in errs.items():
        # the bf16 XLA path rounds each block product and each partial sum
        # to bf16 (2**-9 each): 3 products and 2 sums stay under 2**-6
        limit = 2.0 ** -6 if name.endswith("bf16") else FFN_REL
        check(e <= limit, f"FFN path: {name} {e} > {limit}")
    return errs


def ffn_phase(log):
    """Drive the sparse-activation path with the counts from 0, check its
    results, then hold, time and bound each of its kernels."""
    import torch

    from repro_torch.kernels import ops

    x, w1, w2, h = ffn_operands(seed=0)
    torch.cuda.synchronize()
    ops.reset_launch_counts()  # this path's count starts here
    t0 = time.perf_counter()
    out = ffn_path(x, w1, w2, h)
    path_ms = (time.perf_counter() - t0) * 1e3
    launches = ops.launch_counts()
    routes = ops.route_counts()
    for name in FFN_KERNELS:
        check(launches[name] > 0,
              f"kernel {name} was never launched on the FFN path")
    for name, path in FFN_ROUTES.items():
        check(routes.get(f"{name}/{path}", 0) == launches[name],
              f"FFN path: {name} did not take its {path} route ({routes})")
    errs = check_ffn_outputs(out, h, w2)
    ffn_shape_sweep(log)
    host_ms, dev_ms, top = profile(lambda: ffn_path(x, w1, w2, h))
    emit({"ffn_path": {**FFN, "ms": path_ms, "launches": launches,
                       "route_launches": routes, "checks_rel_err": errs,
                       "profiled": {"host_ms": host_ms, "device_ms": dev_ms,
                                    "device_busy_share": None if dev_ms is None
                                    else dev_ms / host_ms,
                                    "top_kernels": top}}}, log)
    recs = ffn_kernel_records(out, w2, launches, log)

    def dense():
        return torch.matmul(h, w2)

    emit({"dense_down_projection": {
        "shape": [FFN["tokens"], FFN["d_ff"], FFN["d_model"]],
        "dtype": "bfloat16", "ms": time_ms(dense, reps=20),
        "device_ms": device_ms(dense)}}, log)
    return recs


# K3's routes (aia_gather.ranged_route): (dtype, n_blocks, r, d, n_idx, x's
# element offset into its allocation, the route).  16-byte ranges go to the
# 16-byte copy: one vector, 64 vectors, two 16 KB chunks and a ragged 577
# vectors more (bf16 7 x 3,000), ten chunks and 10 vectors (float32 5 x
# 8,200); 12-byte ranges (bf16 1 x 6, float32 1 x 3) and a 16-byte range at
# an x 4 bytes past a 16-byte boundary take the word copy.
RANGED_ROUTES = (
    ("bfloat16", 8, 1, 8, 9, 0, "v16"), ("float32", 8, 2, 128, 7, 0, "v16"),
    ("bfloat16", 6, 7, 3000, 5, 0, "v16"), ("float32", 3, 5, 8200, 4, 0, "v16"),
    ("bfloat16", 8, 1, 6, 9, 0, "words"), ("float32", 8, 1, 3, 9, 0, "words"),
    ("float32", 8, 2, 128, 7, 1, "words"),
)
# K4's bf16 kernel (csrc/bsr_spmm_wgmma.cu): block sizes around its
# 128-row tiles and 64-deep stages at d 40, widths around its 128-column
# tiles at bs 128; bs 12 and d 7 take its element-wise staging (rows that
# are not whole 16-byte chunks), d 7 its scalar stores.  Held in both
# dtypes (float32 goes to the CUDA-core kernel).
BSR_EDGES = tuple((bs, 40) for bs in (8, 12, 16, 64, 128, 200, 256)) \
    + tuple((128, d) for d in (7, 200, 2050)) + ((8, 7),)
# K4's bf16 kernel is persistent (block k takes tiles k, k + grid, ...; a
# grid of 264 on an H100): (block-rows, bs, d) with several tiles a block,
# so that its load cursor crosses tiles, skips empty ones and refills ring
# slots during an epilogue; 40 x 17 column tiles with element-wise B
# staging (d 2,050), and 300 x 2 x 2 tiles with ragged rows, depth and
# columns (bs 200, d 200).  Both dtypes.
BSR_MULTITILE = ((40, 128, 2050), (300, 200, 200))


def bsr_edge_operands(bs, d, dt, randn):
    """Five block-rows over 4 block-columns, max_blocks_per_row 2: a row of
    3 blocks (the third dropped), an empty row, a row naming one column
    twice, a row with ids past both ends of B (clipped), and a row whose
    second slot lies past the last stored block (it reads the last)."""
    import torch

    nbc = 4
    rp = torch.tensor((0, 3, 3, 5, 7, 9), dtype=torch.int32, device="cuda")
    ci = torch.tensor((0, 2, 1, 1, 1, nbc + 3, -2, 3), dtype=torch.int32,
                      device="cuda")
    return rp, ci, randn(8, bs, bs, dtype=dt), randn(nbc * bs, d, dtype=dt), 2


def bsr_multitile_operands(n_brows, bs, d, dt, randn, randint):
    """``n_brows`` block-rows over 6 block-columns, max_blocks_per_row 3:
    row lengths cycle 0, 3, 1, 5, 0, 0, 2 (empty rows alone and in a run,
    rows past max_blocks_per_row), ids from -2 to 8 (clipped at both ends,
    repeats), and the last row's second slot past the last stored block
    (it reads the last).  Returns the operands and the row lengths."""
    import torch

    nbc = 6
    lens = [(0, 3, 1, 5, 0, 0, 2)[i % 7] for i in range(n_brows - 1)] + [2]
    rp = torch.tensor([0] + lens, dtype=torch.int32).cumsum(0).to(
        torch.int32).cuda()
    bcap = sum(lens) - 1
    return (rp, randint(nbc + 3, bcap, lo=-2),
            randn(bcap, bs, bs, dtype=dt), randn(nbc * bs, d, dtype=dt),
            3), lens


def ffn_shape_sweep(log):
    """K3-K6 against their plain versions on the card at the CPU tests'
    shapes (``tests/test_torch_ops.py``), float32 and bfloat16: ragged
    tiles, narrow and odd widths, a block-row past ``max_blocks_per_row``,
    an empty block-row, repeated and out-of-range ids; then K3 on both of
    its routes (``RANGED_ROUTES``) and K4 on its tile edges
    (``BSR_EDGES``), each call counted on the route it should take."""
    import torch

    from repro_torch.kernels import aia_gather, ops, spgemm_bsr, topk_spmm

    g = torch.Generator(device="cuda").manual_seed(1)

    def randn(*shape, dtype):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    def randint(hi, *shape, lo=0):
        return torch.randint(lo, hi, shape, generator=g, device="cuda",
                             dtype=torch.int32)

    def routed(name, path, fn):
        key = f"{name}/{path}"
        before = ops.route_counts().get(key, 0)
        got = fn()
        check(ops.route_counts().get(key, 0) == before + 1,
              f"sweep: {name} did not take its {path} route")
        return got

    cases = 0
    for dt in (torch.float32, torch.bfloat16):
        for nb, r, d, n in ((8, 1, 128, 16), (8, 2, 128, 5), (16, 4, 256, 32),
                            (4, 8, 8, 3)):
            x, idx = randn(nb * r, d, dtype=dt), randint(nb + 2, n, lo=-2)
            check(torch.equal(aia_gather.aia_ranged_gather(x, idx, r),
                              aia_gather.aia_ranged_gather_plain(x, idx, r)),
                  f"sweep: aia_ranged_gather {dt} {(nb, r, d, n)}")
            cases += 1
        bsr_cases = [((0, 3, 4, 7), (0, 2, 3, 1, 3, 0, 1), 8, 16, 4, 2),
                     ((0, 2, 2, 3), (0, 1, 1), 8, 16, 2, 2),
                     ((0, 2, 5, 6), (1, 0, 2, 3, 9), 16, 40, 10, 3),
                     ((0, 1), (1,), 8, 8, 2, 1), ((0, 4, 6), (0, 1, 2, 3, 1, 2),
                                                 128, 200, 4, 4)]
        for rowptr, colidx, bs, d, nbc, mbpr in bsr_cases:
            rp = torch.tensor(rowptr, dtype=torch.int32, device="cuda")
            ci = torch.tensor(colidx, dtype=torch.int32, device="cuda")
            a, b = randn(len(colidx), bs, bs, dtype=dt), randn(nbc * bs, d,
                                                                dtype=dt)
            e = rel_err(spgemm_bsr.bsr_spmm(rp, ci, a, b, mbpr),
                        spgemm_bsr.bsr_spmm_plain(rp, ci, a, b, mbpr))
            check(e <= FFN_REL, f"sweep: bsr_spmm {dt} bs {bs} d {d}: {e}")
            cases += 1
        for bs, d in BSR_EDGES:
            args = bsr_edge_operands(bs, d, dt, randn)
            got = routed("bsr_spmm", spgemm_bsr.route(dt),
                         lambda: spgemm_bsr.bsr_spmm(*args))
            want = spgemm_bsr.bsr_spmm_plain(*args)
            check(bool(torch.isfinite(got).all())
                  and float(got[bs:2 * bs].abs().max()) == 0.0,
                  f"sweep: bsr_spmm {dt} bs {bs} d {d}: the empty row")
            e = rel_err(got, want)
            check(e <= FFN_REL, f"sweep: bsr_spmm {dt} bs {bs} d {d}: {e}")
            cases += 1
        for n_brows, bs, d in BSR_MULTITILE:
            args, lens = bsr_multitile_operands(n_brows, bs, d, dt, randn,
                                                randint)
            case = f"sweep: bsr_spmm {dt} {n_brows} rows bs {bs} d {d}"
            got = routed("bsr_spmm", spgemm_bsr.route(dt),
                         lambda: spgemm_bsr.bsr_spmm(*args))
            want = spgemm_bsr.bsr_spmm_plain(*args)
            empty = torch.tensor(lens, device="cuda") == 0
            check(bool(torch.isfinite(got).all()) and float(
                got.view(n_brows, bs, d)[empty].abs().max()) == 0.0,
                f"{case}: the empty rows")
            e = rel_err(got, want)
            check(e <= FFN_REL, f"{case}: {e}")
            cases += 1
        for n, k, dff, d in ((4, 2, 16, 8), (16, 4, 64, 128), (3, 8, 32, 16),
                             (5, 300, 40, 1100)):
            v, w2 = randn(n, k, dtype=dt), randn(dff, d, dtype=dt)
            idx = randint(dff + 3, n, k, lo=-3)
            check(torch.equal(topk_spmm.topk_spmm(v, idx, w2),
                              topk_spmm.topk_spmm_plain(v, idx, w2)),
                  f"sweep: topk_spmm {dt} {(n, k, dff, d)}")
            cases += 1
        for nt, kb, tile, block, d, ids in K6_EDGES:
            h, w2 = randn(nt, kb, tile, block, dtype=dt), randn(
                (kb + 2) * block, d, dtype=dt)
            bidx = k6_ids(ids, nt, kb, randint)
            case = f"sweep: block_topk_spmm {dt} {(nt, kb, tile, block, d)} {ids}"
            got = routed("block_topk_spmm", topk_spmm.route(dt),
                         lambda: topk_spmm.block_topk_spmm(h, bidx, w2, block))
            e = rel_err(got, topk_spmm.block_topk_spmm_plain(h, bidx, w2,
                                                             block))
            check(e <= FFN_REL, f"{case}: {e}")
            cases += 1
    for dt, nb, r, d, n, off, path in RANGED_ROUTES:
        dt = getattr(torch, dt)
        x = randn(nb * r * d + off, dtype=dt)[off:].view(nb * r, d)
        idx = randint(nb + 2, n, lo=-2)
        case = f"sweep: aia_ranged_gather {dt} {(nb, r, d, n, off)}"
        check(aia_gather.ranged_route(r * d * x.element_size(),
                                      x.data_ptr()) == path,
              f"{case}: not the {path} route")
        got = routed("aia_ranged_gather", path,
                     lambda: aia_gather.aia_ranged_gather(x, idx, r))
        check(torch.equal(got, aia_gather.aia_ranged_gather_plain(x, idx, r)),
              case)
        cases += 1
    emit({"ffn_shape_sweep": {"cases": cases, "ok": True}}, log)


# K6 (block_topk_spmm), both dtypes (bf16: the wgmma kernel of
# csrc/block_topk_spmm_wgmma.cu; float32: the CUDA-core kernel): (n_tiles,
# kb, tile, block, d, ids) over kb + 2 blocks of W2.  ids "clipped": random
# in [-1, kb + 4), clipped at both ends; "repeat": the same, with tile 0
# naming one block twice; "unpicked": ids below kb only, so two blocks go
# unpicked; "every": every tile picks block 1 (300 tiles x 8 rows, far past
# one 64-row chunk).  Blocks 8-128 (24 and 12: not a panel's width; 12:
# element-wise staging of h), tile 11 and tile 1, d 7 (element-wise W2
# staging, scalar atomics) and 2,050 (17 column slices, the last ragged).
K6_EDGES = (
    (2, 2, 8, 16, 32, "clipped"), (4, 3, 8, 128, 64, "clipped"),
    (1, 1, 8, 8, 8, "clipped"), (3, 2, 11, 24, 600, "clipped"),
    (5, 3, 8, 16, 40, "repeat"), (6, 4, 1, 16, 40, "clipped"),
    (4, 3, 5, 12, 33, "unpicked"), (300, 2, 8, 16, 64, "every"),
    (4, 3, 8, 128, 7, "clipped"), (4, 3, 8, 128, 2050, "repeat"),
)


def k6_ids(kind, nt, kb, randint):
    """bidx (nt, kb) for a K6_EDGES case."""
    if kind == "unpicked":
        return randint(kb, nt, kb)
    bidx = randint(kb + 4, nt, kb, lo=-1)
    if kind == "repeat":
        bidx[0, 1] = bidx[0, 0]
    elif kind == "every":
        bidx[:, 0] = 1
    return bidx


FFN_KERNELS = ("aia_ranged_gather", "bsr_spmm", "topk_spmm",
               "block_topk_spmm")
# the route each routed kernel takes on the path: W2's ranges are whole
# 16-byte vectors; the BSR, h and W2 are bf16
FFN_ROUTES = {"aia_ranged_gather": "v16", "bsr_spmm": "wgmma",
              "block_topk_spmm": "wgmma"}
# kernel, its CUDA source, the TPU kernel it replaces
FFN_SOURCES = (
    ("aia_ranged_gather", "aia_gather.cu",
     "src/repro/kernels/aia_gather.py:47"),
    ("bsr_spmm", "bsr_spmm_wgmma.cu", "src/repro/kernels/spgemm_bsr.py:46"),
    ("topk_spmm", "topk_spmm.cu", "src/repro/kernels/topk_spmm.py:40"),
    ("block_topk_spmm", "block_topk_spmm_wgmma.cu",
     "src/repro/kernels/topk_spmm.py:74"),
)
# the CUDA-core kernel of a routed kernel's float32 calls
FLOAT32_SOURCES = {"bsr_spmm": "bsr_spmm.cu",
                   "block_topk_spmm": "topk_spmm.cu"}


def bound(nbytes: int, flops: int, dtype) -> tuple:
    """(bound ms, what binds) for ``nbytes`` at the memory rate and
    ``flops`` at the peak rate of ``dtype``."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[str(dtype)]
    return max(t_bytes, t_ops) * 1e3, \
        "bytes" if t_bytes >= t_ops else "operations"


def hold(name, kernel, plain, exact):
    """One kernel call against its plain version on the same inputs: the
    call adds exactly one launch, and agrees (bit for bit where ``exact``,
    else within FFN_REL of the largest |value|)."""
    import torch

    from repro_torch.kernels import ops

    before = ops.launch_counts()[name]
    got = kernel()
    torch.cuda.synchronize()
    check(ops.launch_counts()[name] == before + 1,
          f"{name}: one call launched {ops.launch_counts()[name] - before}")
    want = plain()
    if torch.equal(got, want):
        return {"max_abs_err": 0.0, "rel_err": 0.0, "bit_exact": True}
    check(not exact, f"{name} differs from its plain version")
    rel = rel_err(got, want)
    check(rel <= FFN_REL, f"{name}: {rel} > {FFN_REL} of the plain version")
    return {"max_abs_err": float((got.double() - want.double()).abs().max()),
            "rel_err": rel, "bit_exact": False}


def library_call(calls):
    """Time the first of ``calls`` (label, fn) that PyTorch accepts; the
    labels of refused ones are kept with their errors."""
    refused = {}
    for label, fn in calls:
        try:
            fn()
        except (RuntimeError, NotImplementedError, TypeError) as exc:
            refused[label] = str(exc).splitlines()[0][:200]
            continue
        return {"library_call": label, "library_ms": time_ms(fn, reps=10),
                "library_device_ms": device_ms(fn, reps=5),
                "library_refused": refused}
    return {"library_call": None, "library_ms": None,
            "library_refused": refused}


def launch_config(fn, kernel: str) -> dict:
    """How one call of ``fn`` launched the kernel whose name holds
    ``kernel``, as the profiler's trace records that launch: shared memory
    a block (static and dynamic), registers a thread, grid and block; {}
    when the trace holds no such launch."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text()).get("traceEvents", [])
    for ev in events:
        if ev.get("cat") == "kernel" and kernel in ev.get("name", ""):
            args = ev.get("args", {})
            return {"shared_memory_bytes": args.get("shared memory"),
                    "registers": args.get("registers per thread"),
                    "grid": args.get("grid"), "block": args.get("block")}
    return {}


def ffn_kernel_records(out, w2, launches, log):
    """Each kernel of the path held (called through its ``ops`` wrapper),
    timed and bounded on the path's own inputs; the bounds count what these
    inputs need (distinct W2 rows or blocks, the B block rows the BSR
    names, the blocks kept)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import aia_gather, ops, spgemm_bsr, topk_spmm

    n, d, f = FFN["tokens"], FFN["d_model"], FFN["d_ff"]
    block, tile, keep = FFN["block"], FFN["tile"], FFN["bsr_keep"]
    nt, kb = n // tile, FFN["k"] // block
    tk, h_kept, bidx, bsr, xt = (out[k] for k in
                                 ("tk", "h_kept", "bidx", "bsr", "xt"))
    vals, idx = tk.values, tk.indices
    flat = bidx.reshape(-1)
    el = w2.element_size()
    nnzb = int(bsr.nnzb)
    row_len = (bsr.indptr[1:] - bsr.indptr[:-1]).clamp(max=keep)
    used = int(row_len.sum())
    b_blocks = int(torch.unique(bsr.indices[:nnzb]).numel())
    w2_view = w2.view(f // block, block * d)
    hk_flat = h_kept.permute(0, 2, 1, 3).reshape(nt, tile, kb * block)
    sel_view = out["w2_sel"].view(nt, kb * block, d)
    with warnings.catch_warnings():  # "sparse BSR support is in beta"
        warnings.simplefilter("ignore")
        lib_bsr = {dt: (torch.sparse_bsr_tensor(
            bsr.indptr, bsr.indices[:nnzb], bsr.blocks[:nnzb].to(dt),
            size=bsr.shape, check_invariants=False), xt.to(dt))
            for dt in (torch.bfloat16, torch.float32)}

    specs = {
        "aia_ranged_gather": dict(
            kernel=lambda: ops.aia_ranged_gather(w2, flat, block),
            plain=lambda: aia_gather.aia_ranged_gather_plain(w2, flat, block),
            exact=True, reps=(10, 3), dtype=w2.dtype,
            nbytes=int(torch.unique(flat).numel()) * block * d * el
            + flat.numel() * (block * d * el + 4), flops=0,
            library=[("index_select on the (n_blocks, R*d) view",
                      lambda: torch.index_select(w2_view, 0, flat.long()))],
            shape={"x": list(w2.shape), "r": block, "n_idx": flat.numel(),
                   "out_gb": flat.numel() * block * d * el / 1e9},
            route=aia_gather.ranged_route(block * d * el, w2.data_ptr()),
            ptxas="ranged_gather_v16_kernel"),
        "bsr_spmm": dict(
            kernel=lambda: ops.bsr_spmm(bsr.indptr, bsr.indices, bsr.blocks,
                                        xt, keep),
            plain=lambda: spgemm_bsr.bsr_spmm_plain(bsr.indptr, bsr.indices,
                                                    bsr.blocks, xt, keep),
            exact=False, reps=(10, 3), dtype=bsr.blocks.dtype,
            nbytes=(bsr.n_brows + 1) * 4 + used * (4 + block * block * el)
            + b_blocks * block * n * el + f * n * 4,
            flops=2 * used * block * block * n,
            library=[(f"torch.sparse_bsr_tensor({dt}) @ b",
                      lambda dt=dt: lib_bsr[dt][0] @ lib_bsr[dt][1])
                     for dt in lib_bsr],
            shape={"a": list(bsr.shape), "block": block, "nnzb": nnzb,
                   "b": list(xt.shape)},
            route=spgemm_bsr.route(bsr.blocks.dtype),
            ptxas="bsr_spmm_wgmma_kernel"),
        "topk_spmm": dict(
            kernel=lambda: ops.topk_spmm(vals, idx, w2),
            plain=lambda: topk_spmm.topk_spmm_plain(vals, idx, w2),
            exact=True, reps=(10, 1), dtype=vals.dtype,
            nbytes=vals.numel() * (el + 4)
            + int(torch.unique(idx).numel()) * d * el + n * d * 4,
            flops=2 * vals.numel() * d,
            library=[("F.embedding_bag(mode='sum', per_sample_weights)",
                      lambda: F.embedding_bag(idx, w2,
                                              per_sample_weights=vals,
                                              mode="sum"))],
            shape={"vals": list(vals.shape), "w2": list(w2.shape)}),
        "block_topk_spmm": dict(
            kernel=lambda: ops.block_topk_spmm(h_kept, bidx, w2, block),
            plain=lambda: topk_spmm.block_topk_spmm_plain(h_kept, bidx, w2,
                                                          block),
            exact=False, reps=(10, 3), dtype=h_kept.dtype,
            nbytes=h_kept.numel() * el + bidx.numel() * 4
            + int(torch.unique(bidx).numel()) * block * d * el + n * d * 4,
            flops=2 * h_kept.numel() * d,
            library=[("torch.bmm on the pre-gathered blocks (gather "
                      "excluded)", lambda: torch.bmm(hk_flat, sel_view))],
            shape={"h_kept": list(h_kept.shape), "w2": list(w2.shape)},
            route=topk_spmm.route(h_kept.dtype),
            ptxas="block_topk_wgmma_kernel"),
    }
    recs = {}
    for name, sp in specs.items():
        rec = {"name": name, "launches": launches[name], "shape": sp["shape"]}
        if "route" in sp:
            rec["route"] = sp["route"]
            rec["ptxas"] = ptxas_report(sp["ptxas"])
        rec.update(hold(name, sp["kernel"], sp["plain"], sp["exact"]))
        reps, plain_reps = sp["reps"]
        rec["ms"] = time_ms(sp["kernel"], reps=reps)
        # device time per call: every launch of the call (K6's bf16 route:
        # the selection's inversion with y's zero fill, and the product),
        # and the largest kernel's own mean
        _, dev, top = profile(lambda: [sp["kernel"]() for _ in range(5)])
        rec["device_ms"] = None if dev is None else dev / 5
        rec["kernel_device_ms"] = top[0][1] / top[0][2] if top else None
        rec["device_launches_recorded"] = top[0][2] if top else 0
        rec["device_kernels"] = [(k, ms / n) for k, ms, n in top]
        rec["plain_ms"] = time_ms(sp["plain"], reps=plain_reps, warmup=0)
        rec["plain_device_ms"] = device_ms(sp["plain"], reps=1)
        rec["bound_ms"], rec["bound_by"] = bound(sp["nbytes"], sp["flops"],
                                                 sp["dtype"])
        rec["bytes"], rec["flops"] = sp["nbytes"], sp["flops"]
        rec.update(library_call(sp["library"]))
        if "route" in sp:
            rec["launch"] = launch_config(sp["kernel"], sp["ptxas"])
        if name in ("bsr_spmm", "block_topk_spmm"):
            rec["tflops"] = sp["flops"] / rec["device_ms"] / 1e9 \
                if rec["device_ms"] else None
        emit({"ffn_kernel": rec}, log)
        recs[name] = rec
        torch.cuda.empty_cache()
    return recs


# ---------------------------------------------------------------------------
# Phase 4: K7 (flash attention) against its plain version, then timed
# ---------------------------------------------------------------------------

# tests/test_flash_kernel.py's shapes (bh, s, d, q_blk, k_blk), then
# Phi-3-mini's prefill: batch 2 x 32 heads, 4,096 tokens, head dim 96, bf16
FLASH_CASES = ((2, 64, 32, 16, 16), (1, 128, 64, 32, 64), (3, 32, 16, 32, 16))
# the bf16 kernel's edges: D = 7 (odd: element-wise staging, scalar
# stores), 36 (even, not a multiple of 8: element-wise staging, paired
# stores), 40 (one panel, padded), 96 (two panels, the second half used),
# 128; S = 64 (one kv tile, half a query block) and 192 (a partial query
# block); q_blk = k_blk = 64 for the divisibility contract
FLASH_EDGES = tuple((2, s, d, 64, 64) for d in (7, 36, 40, 96, 128)
                    for s in (64, 192))
# the float32 kernel at the decode check's shape (1 x 32 heads, a 512-token
# prompt, D 96)
FLASH_F32 = ((32, 512, 96, 128, 128),)
FLASH_PHI3 = (64, 4096, 96, 128, 128)
# (rtol, atol) against the plain version: float32 sums in another order;
# a bf16 output is rounded once, so a sum near a rounding boundary may round
# the other way, one bf16 step (2**-7 of the value)
FLASH_TOL = {"torch.float32": (1e-5, 1e-5), "torch.bfloat16": (2 ** -7, 1e-6)}


def flash_hold(q, k, v, causal, q_blk, k_blk):
    """One K7 call through ``ops`` against its plain version on the same
    inputs: exactly one launch, and within FLASH_TOL; the max |error|."""
    import torch

    from repro_torch.kernels import flash_attention as k7
    from repro_torch.kernels import ops

    before = ops.launch_counts()["flash_attention_fused"]
    got = ops.flash_attention_fused(q, k, v, causal, q_blk, k_blk)
    torch.cuda.synchronize()
    n = ops.launch_counts()["flash_attention_fused"] - before
    check(n == 1, f"flash_attention_fused: one call launched {n}")
    want = k7.flash_attention_fused_plain(q, k, v, causal, q_blk, k_blk)
    rtol, atol = FLASH_TOL[str(q.dtype)]
    diff = (got.double() - want.double()).abs()
    case = (str(q.dtype), causal, tuple(q.shape), q_blk, k_blk)
    check(got.dtype == q.dtype and got.shape == q.shape,
          f"flash_attention_fused {case}: {got.dtype} {tuple(got.shape)}")
    check(bool((diff <= atol + rtol * want.double().abs()).all()),
          f"flash_attention_fused {case}: max |error| {float(diff.max())} "
          f"beyond rtol {rtol} atol {atol} of its plain version")
    return float(diff.max())


def flash_phase(log):
    """Hold K7 against its plain version on the 12 cases of the reference's
    kernel test, the bf16 kernel's tile edges and the Phi-3 prefill shape,
    then time it there beside its bound, its plain version and
    ``scaled_dot_product_attention``; then hold and time the float32 route
    there."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as k7
    from repro_torch.kernels import ops

    g = torch.Generator(device="cuda").manual_seed(2)

    def rand(shape, dtype):
        return [torch.randn(shape, generator=g, device="cuda").to(dtype)
                for _ in range(3)]

    errs = {}
    for dt in (torch.float32, torch.bfloat16):
        for causal in (True, False):
            cases = FLASH_CASES + (FLASH_EDGES if dt == torch.bfloat16
                                   else FLASH_F32)
            for bh, s, d, qb, kb in cases:
                errs[f"{dt}/{causal}/{bh}x{s}x{d}"] = flash_hold(
                    *rand((bh, s, d), dt), causal, qb, kb)
    emit({"flash_cases": {"cases": len(errs), "max_abs_err": errs}}, log)

    bh, s, d, qb, kb = FLASH_PHI3
    q, k, v = rand((bh, s, d), torch.bfloat16)
    rec = {"name": "flash_attention_fused", "route": k7.route(q.dtype),
           "shape": {"bh": bh, "s": s, "d": d, "dtype": "bfloat16",
                     "causal": True},
           "max_abs_err": flash_hold(q, k, v, True, qb, kb)}

    def kernel():
        return ops.flash_attention_fused(q, k, v, True)

    def plain():
        return k7.flash_attention_fused_plain(q, k, v, True)

    q4, k4, v4 = (x.view(2, bh // 2, s, d) for x in (q, k, v))
    rec["ms"] = time_ms(kernel, reps=10)
    _, _, top = profile(lambda: [kernel() for _ in range(5)])
    rec["device_ms"] = top[0][1] / top[0][2] if top else None
    rec["device_launches_recorded"] = top[0][2] if top else 0
    rec["plain_ms"] = time_ms(plain, reps=3)
    rec["plain_device_ms"] = device_ms(plain, reps=1)
    # what this causal call needs: Q.K^T and P.V over the s(s+1)/2 pairs on
    # and below the diagonal (2 FLOP per multiply-add); q, k, v read once
    # and o written once
    rec["flops"] = 4 * bh * d * s * (s + 1) // 2
    rec["bytes"] = 4 * bh * s * d * q.element_size()
    rec["bound_ms"], rec["bound_by"] = bound(rec["bytes"], rec["flops"],
                                             q.dtype)
    rec["tflops"] = rec["flops"] / rec["device_ms"] / 1e9 \
        if rec["device_ms"] else None
    # what the tensor cores do: Q.K^T once, P.V once for each bf16 term of P
    consts = k7.wgmma_constants()
    rec["tensor_flops"] = rec["flops"] * (1 + consts["kPTerms"]) // 2
    rec["tensor_bound_ms"] = bound(0, rec["tensor_flops"], q.dtype)[0]
    rec["ptxas"] = ptxas_report(f"flash_wgmma_kernelILi{d}E")
    rec["launch"] = launch_config(kernel, "flash_wgmma_kernel")
    rec.update(library_call([(
        "F.scaled_dot_product_attention(is_causal=True) on (2, 32, s, d)",
        lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True))]))
    emit({"flash_kernel": rec}, log)

    # the float32 route at the same shape
    del q4, k4, v4
    q, k, v = (x.float() for x in (q, k, v))
    f32 = {"route": k7.route(q.dtype),
           "max_abs_err": flash_hold(q, k, v, True, qb, kb),
           "ms": time_ms(kernel, reps=3)}
    _, _, top = profile(lambda: [kernel() for _ in range(3)])
    f32["device_ms"] = top[0][1] / top[0][2] if top else None
    f32["ptxas"] = ptxas_report(f"flash_kernelILi{(d + 15) // 16}E")
    emit({"flash_kernel_f32": f32}, log)
    return rec


def ptxas_report(kernel: str) -> dict:
    """Registers, spills and static shared memory of the kernel whose
    mangled name holds ``kernel``, from ``ptxas -v`` in ``build.log``."""
    import re

    from repro_torch.kernels._build import build

    text = (build().parent / "build.log").read_text()
    blocks = text.split("Compiling entry function '")[1:]
    for block in blocks:
        if kernel in block.split("'", 1)[0]:
            nums = {k: int(v) for v, k in re.findall(
                r"(\d+) (bytes spill stores|bytes spill loads|registers|"
                r"bytes smem)", block)}
            return {"registers": nums.get("registers"),
                    "spill_stores": nums.get("bytes spill stores"),
                    "spill_loads": nums.get("bytes spill loads"),
                    "static_smem_bytes": nums.get("bytes smem", 0)}
    return {}


# ---------------------------------------------------------------------------
# Phase 5: the LM path at Phi-3-mini's full width and depth
# ---------------------------------------------------------------------------

# Phi-3-mini-4k: batch 2 x its 4,096-token context for the prefill forward;
# the decode check at full width, 4 layers, float32, on a 512-token prompt;
# the server: 4 requests of 4-6 prompt tokens x 8 new tokens
LM = {"arch": "phi3-mini-3.8b", "batch": 2, "seq": 4096,
      "decode_layers": 4, "decode_prompt": 512,
      "requests": 4, "new_tokens": 8, "slots": 4, "max_seq": 64}
LM_LOSS_BAND = (-1.0, 2.0)  # around ln(vocab), for random weights
# decode logits against the prefill's last position, over the largest
# |logit|: float32 sums in other orders (GEMV against GEMM, the decode
# softmax against K7's online one) through 4 layers
DECODE_REL = 1e-4


def lm_prefill(cfg, params, log):
    """``train_loss`` forward-only at batch x seq with the counts from 0:
    one K7 launch per layer, and the loss inside its band."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models.transformer import train_loss

    rng = np.random.default_rng(0)
    shape = (LM["batch"], LM["seq"])
    batch = {name: torch.from_numpy(rng.integers(0, cfg.vocab, shape)
                                    .astype(np.int32)).cuda()
             for name in ("tokens", "labels")}

    def forward():
        with torch.no_grad():
            return train_loss(cfg, params, batch)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()  # this path's count starts here
    t0 = time.perf_counter()
    loss = float(forward())
    ms = (time.perf_counter() - t0) * 1e3
    launches = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    lnv = float(np.log(cfg.vocab))
    check(np.isfinite(loss), f"LM prefill: loss {loss}")
    check(lnv + LM_LOSS_BAND[0] <= loss <= lnv + LM_LOSS_BAND[1],
          f"LM prefill: loss {loss} outside ln(vocab) {lnv} "
          f"{LM_LOSS_BAND}")
    check(launches["flash_attention_fused"] == cfg.n_layers,
          f"LM prefill: {launches['flash_attention_fused']} K7 launches for "
          f"{cfg.n_layers} layers")
    host_ms, dev_ms, top = profile(forward)
    rec = {"arch": cfg.name, "layers": cfg.n_layers, "dtype": cfg.dtype,
           "batch": LM["batch"], "seq": LM["seq"], "loss": loss,
           "ln_vocab": lnv, "ms": ms, "launches": launches,
           "peak_mem_gb": peak_gb,
           "tokens_per_s": LM["batch"] * LM["seq"] / (ms / 1e3),
           "profiled": {"host_ms": host_ms, "device_ms": dev_ms,
                        "device_busy_share": None if dev_ms is None
                        else dev_ms / host_ms, "top_kernels": top}}
    emit({"lm_prefill": rec}, log)
    return rec


def lm_serve(cfg, params, log):
    """The ServeEngine answers its requests at full depth, with the counts
    from 0 (decode attention is plain PyTorch, so no kernel launches)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.serve import Request, ServeEngine

    rng = np.random.default_rng(0)
    eng = ServeEngine(cfg, params, batch_slots=LM["slots"],
                      max_seq=LM["max_seq"])
    for i in range(LM["requests"]):
        eng.submit(Request(prompt=rng.integers(0, cfg.vocab, 4 + i % 3),
                           max_new_tokens=LM["new_tokens"]))
    torch.cuda.synchronize()
    ops.reset_launch_counts()  # this path's count starts here
    t0 = time.perf_counter()
    done = eng.run()
    ms = (time.perf_counter() - t0) * 1e3
    launches = ops.launch_counts()
    check(len(done) == LM["requests"]
          and all(len(r.out_tokens) == LM["new_tokens"]
                  and all(0 <= tok < cfg.vocab for tok in r.out_tokens)
                  for r in done), "server: a request went unanswered")
    rec = {"arch": cfg.name, "layers": cfg.n_layers, "dtype": cfg.dtype,
           "requests": len(done), "steps": eng.steps, "ms": ms,
           "ms_per_decode_step": ms / eng.steps, "launches": launches,
           "out_tokens": [r.out_tokens for r in done]}
    emit({"lm_serve": rec}, log)
    return rec


def lm_decode_check(base, log):
    """Float32 at full width, ``decode_layers`` layers: the logits of
    ``decode_step`` after the prompt fed token by token against the
    prefill forward's last position."""
    import dataclasses

    import torch

    from repro_torch.kernels import ops
    from repro_torch.models.transformer import (decode_step, forward_hidden,
                                                init_decode_cache,
                                                init_transformer)

    cfg = dataclasses.replace(base, n_layers=LM["decode_layers"],
                              dtype="float32")
    params = init_transformer(
        cfg, torch.Generator(device="cuda").manual_seed(1), device="cuda")
    n = LM["decode_prompt"]
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (1, n)).astype(np.int32)).cuda()
    with torch.no_grad():
        ops.reset_launch_counts()  # this path's count starts here
        h, _ = forward_hidden(cfg, params, toks)
        prefill = (h[:, -1] @ params["lm_head"]).double()
        launches = ops.launch_counts()
        cache = init_decode_cache(cfg, 1, n, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            logits, cache = decode_step(cfg, params, cache, toks[:, i:i + 1])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    decoded = logits[:, 0].double()
    rel = rel_err(decoded, prefill)
    check(launches["flash_attention_fused"] == cfg.n_layers,
          f"decode check: {launches['flash_attention_fused']} K7 launches")
    check(rel <= DECODE_REL, f"decode check: decode vs prefill logits "
                             f"{rel} > {DECODE_REL} of the largest |logit|")
    rec = {"arch": cfg.name, "layers": cfg.n_layers, "dtype": cfg.dtype,
           "reduced": {"layers": f"{cfg.n_layers} of {base.n_layers}",
                       "dtype": f"float32 for {base.dtype}"},
           "prompt": n, "rel_err": rel, "tolerance": DECODE_REL,
           "max_abs_err": float((decoded - prefill).abs().max()),
           "same_argmax": bool(decoded.argmax() == prefill.argmax()),
           "prefill_launches": launches, "decode_ms": ms,
           "ms_per_decode_step": ms / n}
    emit({"lm_decode_vs_prefill": rec}, log)
    return rec


def lm_phase(log):
    """Phi-3-mini at full width and depth in bf16 with random weights from
    a seeded generator: the prefill forward, then the server; then the
    float32 decode-against-prefill check at 4 layers."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_transformer

    cfg = get_config(LM["arch"])
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = init_transformer(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    emit({"lm_init": {"arch": cfg.name, "layers": cfg.n_layers,
                      "seconds": time.perf_counter() - t0,
                      "param_gb": (torch.cuda.memory_allocated() - before)
                      / 1e9}}, log)
    prefill = lm_prefill(cfg, params, log)
    serve = lm_serve(cfg, params, log)
    del params
    torch.cuda.empty_cache()
    decode = lm_decode_check(cfg, log)
    torch.cuda.empty_cache()
    return prefill, serve, decode


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--json", help="also write every record to this file")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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

    # the sparse-activation path first, so its profiles do not follow the
    # SpGEMM calls' traces of many thousand launches
    ffn = ffn_phase(log)
    torch.cuda.empty_cache()
    # then K7 and the LM path, still ahead of the SpGEMM traces
    flash = flash_phase(log)
    torch.cuda.empty_cache()
    prefill, _, _ = lm_phase(log)
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
         "library_ms": None, "path": k2["route"], "chunks": k2["chunks"]},
    ]
    for name, src, tpu in FFN_SOURCES:
        rec = ffn[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": tpu, "tpu_kernel": f"{tpu.split(':')[0]}:{name}",
            "shape": rec["shape"], "launches": rec["launches"],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "kernel_ms": rec["ms"], "device_ms": rec["device_ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
            "library_call": rec["library_call"]})
        if "route" in rec:  # the CUDA kernel the path's call took
            kernels[-1].update(path=rec["route"], ptxas=rec["ptxas"],
                               launch=rec["launch"])
        if name in FLOAT32_SOURCES:
            kernels[-1]["float32_source"] = \
                f"src/repro_torch/kernels/csrc/{FLOAT32_SOURCES[name]}"
    kernels.append({
        "name": "flash_attention_fused", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_wgmma.cu",
        "float32_source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:73",
        "tpu_kernel": "src/repro/kernels/flash_attention.py:"
                      "flash_attention_fused",
        "shape": flash["shape"],
        "launches": prefill["launches"]["flash_attention_fused"],
        "max_abs_err": flash["max_abs_err"], "ms": flash["ms"],
        "kernel_ms": flash["ms"], "device_ms": flash["device_ms"],
        "plain_ms": flash["plain_ms"], "bound_ms": flash["bound_ms"],
        "bound_by": flash["bound_by"], "library_ms": flash["library_ms"],
        "library_call": flash["library_call"]})
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
