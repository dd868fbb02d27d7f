"""Markov Clustering (paper Algorithm 6) on the SpGEMM pipeline.

Expansion (A^e) is the SpGEMM; pruning keeps the top k per column above θ;
inflation is a Hadamard power and a column normalization.  Counterpart of
``repro.apps.markov_clustering``, on the device ``g`` lives on.  Two
helpers compute the reference's results another way, so that they scale
to paper-size graphs: ``_change`` takes the largest entry difference over
the union of both structures without densifying, and
``interpret_clusters`` finds the connected components with scipy in place
of ``networkx``.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from repro_torch.core import executor
from repro_torch.core.spgemm import PlanCache, spgemm, spgemm_streamed
from repro_torch.sparse.formats import CSR
from repro_torch.sparse.ops import (
    csr_column_normalize,
    csr_hadamard_power,
    csr_prune_columns,
)


@dataclasses.dataclass
class MCLResult:
    matrix: CSR
    clusters: np.ndarray  # cluster id per node
    n_iterations: int
    spgemm_info: List[dict]
    # Alg. 1 + Table-I setups skipped because the expansion's support was
    # unchanged from an earlier iteration (``reuse_plan=True``).
    plan_cache_hits: int = 0


def _coo(a: CSR):
    """(row * n_cols + col, value) of each occupied slot (one host read of
    the occupancy)."""
    nnz = int(a.nnz)
    key = a.row_ids()[:nnz].long() * a.n_cols + a.indices[:nnz].long()
    return key, a.data[:nnz]


def add_self_loops(g: CSR, weight: float = 1.0) -> CSR:
    """AddSelfLoops(G) on ``g``'s device: entries sorted by (row, col), a
    diagonal entry already present summed with ``weight``, the capacity
    the merged nnz."""
    n = g.n_rows
    dev = g.device
    key, vals = _coo(g)
    diag = torch.arange(n, device=dev)
    key = torch.cat([key, diag * g.n_cols + diag])
    vals = torch.cat([vals, torch.full((n,), weight, dtype=vals.dtype,
                                       device=dev)])
    skey, order = torch.sort(key, stable=True)
    uniq, inv = torch.unique_consecutive(skey, return_inverse=True)
    data = torch.zeros(uniq.shape[0], dtype=vals.dtype, device=dev)
    data.index_add_(0, inv, vals[order])
    rows = uniq // g.n_cols
    indptr = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    indptr[1:] = torch.cumsum(torch.bincount(rows, minlength=n), 0,
                              dtype=torch.int32)
    return CSR(indptr, (uniq % g.n_cols).to(torch.int32), data, g.shape)


def _change(a: CSR, b: CSR) -> float:
    """max |a - b| over all entries, in float64: the reference densifies
    both (summing repeated entries); here each matrix's entries are summed
    per (row, col) over the union of both structures."""
    ka, va = _coo(a)
    kb, vb = _coo(b)
    if ka.numel() + kb.numel() == 0:
        return 0.0
    uniq, inv = torch.unique(torch.cat([ka, kb]), return_inverse=True)
    sa = torch.zeros(uniq.shape[0], dtype=va.dtype, device=va.device)
    sb = torch.zeros(uniq.shape[0], dtype=vb.dtype, device=vb.device)
    sa.index_add_(0, inv[: ka.numel()], va)
    sb.index_add_(0, inv[ka.numel():], vb)
    return float((sa.double() - sb.double()).abs().max())


def interpret_clusters(a: CSR) -> np.ndarray:
    """Connected components of the support above 1e-6 (the attractors),
    numbered in the order of each component's smallest node."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    nnz = int(a.nnz)
    keep = a.data[:nnz] > 1e-6
    rows = a.row_ids()[:nnz][keep].cpu().numpy()
    cols = a.indices[:nnz][keep].cpu().numpy()
    n = a.n_rows
    adj = coo_matrix((np.ones(len(rows), np.int8), (rows, cols)), shape=(n, n))
    _, labels = connected_components(adj, directed=True, connection="weak")
    _, first = np.unique(labels, return_index=True)
    rank = np.empty(len(first), np.int64)
    rank[np.argsort(first)] = np.arange(len(first))
    return rank[labels]


def mcl(
    g: CSR,
    e: int = 2,
    r: float = 2.0,
    theta: float = 1e-4,
    k: int = 32,
    max_iters: int = 16,
    tol: float = 1e-4,
    method: str = "sort",
    gather: str = "auto",
    schedule: str = "grouped",
    mesh=None,
    reuse_plan: bool = True,
    pipeline: str = "two_wave",
    sizing: str = "auto",
    stream: int = None,
    prefetch: int = 2,
    on_budget: str = "error",
) -> MCLResult:
    """Algorithm 6.  ``e=2`` expansion = one SpGEMM self-product per iter.

    ``gather``/``schedule``/``sizing`` pick the executor's lanes as in
    ``spgemm``.  ``reuse_plan`` keeps a per-run ``PlanCache`` over the
    expansions: once the support stabilizes, every further iteration skips
    Algorithm 1 and the Table-I binning (``MCLResult.plan_cache_hits``).
    ``pipeline`` picks the two-wave or the legacy (per-chunk read) sync
    structure; ``method="auto"`` dispatches one engine per Table-I bin
    through the executor's autotune cache.  ``stream`` runs every
    expansion through the out-of-core lane (``spgemm_streamed``) with
    ``stream`` rows a tile and ``prefetch`` tiles in flight, the plan cache
    then keeping tile plans; ``on_budget="stream"`` lets a monolithic
    expansion whose plan exceeds ``executor.set_device_budget`` degrade to
    that lane instead of raising ``DeviceBudgetExceeded``.  Both give the
    monolithic run's result bit for bit on a deterministic lane.  ``mesh``
    runs every expansion through the sharded executor (``g`` on its merge
    device), with the same result.
    """
    if pipeline not in ("two_wave", "legacy"):
        raise ValueError(f"unknown pipeline {pipeline!r}")
    method = executor.resolve_engine(method)
    stream = None if stream is None else executor.resolve_tile_rows(stream)
    on_budget = executor.resolve_on_budget(on_budget)
    a = add_self_loops(g)
    a = csr_column_normalize(a)
    plan_cache = PlanCache() if reuse_plan else None
    infos = []
    it = 0
    for it in range(1, max_iters + 1):
        prev = a
        # Expansion: B <- A^e  (e-1 SpGEMM products)
        b = a
        for _ in range(e - 1):
            if stream is not None:
                res = spgemm_streamed(
                    b, a, tile_rows=stream, prefetch=prefetch,
                    engine=method, gather=gather, schedule=schedule,
                    mesh=mesh, plan=plan_cache, pipeline=pipeline,
                    sizing=sizing)
            else:
                res = spgemm(b, a, engine=method, gather=gather,
                             schedule=schedule, mesh=mesh, plan=plan_cache,
                             pipeline=pipeline, sizing=sizing,
                             on_budget=on_budget)
            infos.append(res.info)
            b = res.c
        # Prune: drop < theta, keep top-k per column
        c = csr_prune_columns(b, theta, k)
        # Inflation: Hadamard power + column normalize
        c = csr_hadamard_power(c, r)
        a = csr_column_normalize(c)
        if a.shape == prev.shape and _change(a, prev) < tol:
            break
    clusters = interpret_clusters(a)
    return MCLResult(matrix=a, clusters=clusters, n_iterations=it,
                     spgemm_info=infos,
                     plan_cache_hits=plan_cache.hits if plan_cache else 0)
