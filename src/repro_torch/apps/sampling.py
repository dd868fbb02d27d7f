"""Matrix-based bulk neighbourhood sampling (paper §V-C, Tripathy et al.).

Counterpart of ``repro.apps.sampling``.  Mini-batch GNN sampling as a
chain of SpGEMMs, for each layer l = L..1:

  1. probabilities:  P = Q^l · A            (SpGEMM)
  2. normalisation:  NORM(P)                (row-stochastic, GraphSAGE)
  3. sampling:       Q^{l-1} = SAMPLE(P, s) (inverse transform, s per row)
  4. extraction:     A^l = R · A · Cᵀ       (two SpGEMMs with selection
                                             matrices)

Every CSR lives on the device of ``a``.  The steps the reference takes on
the host stay there, so that the draws are the reference's: ``norm_rows``
sums each row with ``np.add.at`` in slot order (P's row ids and values
read back once) and scales on the device; ``sample_rows`` is the
reference's per-row loop over one ``np.random.Generator``.

``plan_cache=`` serves every SpGEMM of the chain from one ``PlanCache``
(epoch-revisited batches repeat their patterns); ``weight_sets=`` runs
the probability step as one batched SpGEMM over an ensemble of edge
reweightings sharing A's support and samples from their mean.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import executor
from repro_torch.core.spgemm import spgemm, spgemm_batched
from repro_torch.launch.sharding import shard_devices
from repro_torch.sparse.formats import CSR, csr_from_coo
from repro_torch.sparse.ops import csr_scale_rows, csr_transpose


def selection_matrix(vertices: np.ndarray, n: int, device="cuda") -> CSR:
    """R with R[i, vertices[i]] = 1 (row extraction by SpGEMM), built on
    ``device``."""
    vertices = np.asarray(vertices)
    b = len(vertices)
    return csr_from_coo(np.arange(b), vertices, np.ones(b, np.float32),
                        (b, n), device=device)


def norm_rows(p: CSR) -> CSR:
    """GraphSAGE NORM: each row of P becomes a probability distribution.
    The row sums are the reference's (float32, ``np.add.at`` in slot
    order, on the host); the scaling runs on P's device."""
    indptr = p.indptr.cpu().numpy().astype(np.int64)
    nnz = int(indptr[-1])
    data = p.data[:nnz].cpu().numpy()
    rid = np.repeat(np.arange(p.n_rows), np.diff(indptr))
    rowsum = np.zeros(p.n_rows, np.float32)
    np.add.at(rowsum, rid, data)
    inv = np.where(rowsum > 0, 1.0 / np.maximum(rowsum, 1e-12), 0.0)
    return csr_scale_rows(p, torch.from_numpy(inv.astype(np.float32))
                          .to(p.device))


def sample_rows(p: CSR, s: int, rng: np.random.Generator) -> np.ndarray:
    """Inverse-transform sampling: at most ``s`` distinct columns per row of
    P, drawn row by row from ``rng`` as the reference draws them."""
    indptr = p.indptr.cpu().numpy()
    nnz = int(indptr[-1])
    indices = p.indices[:nnz].cpu().numpy()
    data = p.data[:nnz].cpu().numpy()
    picks = set()
    for i in range(p.n_rows):
        lo, hi = indptr[i], indptr[i + 1]
        cols = indices[lo:hi]
        w = np.maximum(data[lo:hi], 0)
        if len(cols) == 0 or w.sum() <= 0:
            continue
        k = min(s, len(cols))
        chosen = rng.choice(cols, size=k, replace=False, p=w / w.sum())
        picks.update(int(c) for c in chosen)
    return np.asarray(sorted(picks), np.int64)


def extract(a: CSR, rows: np.ndarray, cols: np.ndarray,
            engine: str = "sort", gather: str = "auto", mesh=None,
            plan_cache=None, pipeline: str = "two_wave",
            sizing: str = "auto") -> CSR:
    """A[rows, cols] as R · A · Cᵀ: two SpGEMMs with selection matrices,
    on ``a``'s device.  ``engine`` is any registered engine or ``"auto"``,
    validated up front; ``mesh`` runs both through the sharded executor."""
    engine = executor.resolve_engine(engine)
    r = selection_matrix(rows, a.n_rows, a.device)
    c = selection_matrix(cols, a.n_cols, a.device)
    ra = spgemm(r, a, engine=engine, gather=gather, mesh=mesh,
                plan=plan_cache, pipeline=pipeline, sizing=sizing).c
    return spgemm(ra, csr_transpose(c), engine=engine, gather=gather,
                  mesh=mesh, plan=plan_cache, pipeline=pipeline,
                  sizing=sizing).c


def _weighted_members(a: CSR, weight_sets: np.ndarray) -> List[CSR]:
    """CSRs sharing ``a``'s structure tensors, with one row of
    ``weight_sets`` (W, nnz) as each member's values."""
    weight_sets = np.asarray(
        weight_sets, torch.empty((), dtype=a.data.dtype).numpy().dtype)
    nnz = int(a.nnz)
    if weight_sets.ndim != 2 or weight_sets.shape[1] != nnz:
        raise ValueError(
            f"weight_sets must be (n_members, nnz={nnz}), "
            f"got {weight_sets.shape}")
    members = []
    for w in weight_sets:
        data = np.zeros(a.capacity, weight_sets.dtype)
        data[:nnz] = w
        members.append(CSR(a.indptr, a.indices,
                           torch.from_numpy(data).to(a.device), a.shape))
    return members


def _ensemble_mean(cs: List[CSR]) -> CSR:
    """The mean of same-structure CSRs (batched-SpGEMM outputs share one
    structure)."""
    data = torch.stack([c.data for c in cs]).mean(0)
    t = cs[0]
    return CSR(t.indptr, t.indices, data, t.shape)


def bulk_sample(
    a: CSR,
    batch_vertices: np.ndarray,
    fanout: int,
    n_layers: int,
    seed: int = 0,
    engine: str = "sort",
    gather: str = "auto",
    mesh=None,
    plan_cache=None,
    weight_sets: Optional[np.ndarray] = None,
    pipeline: str = "two_wave",
    sizing: str = "auto",
) -> Tuple[List[CSR], List[np.ndarray]]:
    """GraphSAGE-style L-layer sampling for one mini-batch, on ``a``'s
    device.

    Returns (adjacencies A^{L-1}..A^0 outermost-first, frontier vertex
    lists Q^L..Q^0 as host arrays); A^l has shape (|Q^l|, |Q^{l+1}|).
    ``engine``/``gather``/``pipeline``/``sizing`` pick the executor's lanes
    for every SpGEMM of the chain, ``plan_cache`` (a ``PlanCache``) serves
    their plans, and ``weight_sets`` (W, nnz) turns each probability step
    into one ``spgemm_batched`` over the reweightings, sampling from their
    mean.  ``mesh`` runs every SpGEMM of the chain through the sharded
    executor (``a`` on its merge device).
    """
    shard_devices(mesh)  # a bad mesh fails before any work
    engine = executor.resolve_engine(engine)
    rng = np.random.default_rng(seed)
    frontiers = [np.asarray(batch_vertices, np.int64)]
    adjs: List[CSR] = []
    q_cur = frontiers[0]
    members = (None if weight_sets is None
               else _weighted_members(a, weight_sets))
    for _ in range(n_layers):
        q_mat = selection_matrix(q_cur, a.n_rows, a.device)
        if members is None:
            p = spgemm(q_mat, a, engine=engine, gather=gather, mesh=mesh,
                       plan=plan_cache, pipeline=pipeline,
                       sizing=sizing).c  # P = Q^l · A
        else:
            batch = spgemm_batched(q_mat, members, engine=engine,
                                   gather=gather, mesh=mesh, plan=plan_cache,
                                   pipeline=pipeline, sizing=sizing)
            p = _ensemble_mean(batch.cs)
        p = norm_rows(p)                            # NORM
        sampled = sample_rows(p, fanout, rng)       # SAMPLE
        q_next = np.unique(np.concatenate([q_cur, sampled]))  # self + nbrs
        adjs.append(extract(a, q_cur, q_next, engine=engine, gather=gather,
                            mesh=mesh, plan_cache=plan_cache,
                            pipeline=pipeline, sizing=sizing))
        frontiers.append(q_next)
        q_cur = q_next
    return adjs, frontiers
