"""CSR primitives on the operands' device, with static capacities.

Counterpart of ``repro.sparse.ops``: the substrate the paper's applications
are built on.  Markov Clustering needs column normalization, Hadamard
powers and top-k column pruning (Algorithm 6); Graph Contraction needs
transposes (Algorithm 7); GNNs need SpMM.  Every op keeps the capacity of
its inputs and reads nothing back to the host.

``csr_spmm`` serves its row gather ``X[indices]`` through ``_TakeRows``:
the AIA row-gather kernel (``kernels.aia_gather.gather_rows``) for
``gather="aia"``, a clipped take for ``"xla"``; its backward is an
``index_add`` of the cotangent at the clipped ids either way.  On CUDA the
segment sums (``index_add``) use atomics, so ``csr_spmv``, ``csr_spmm``
and ``csr_column_sums`` sum in another order than the reference there; on
the CPU they add in index order, as the reference does.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.aia_gather import gather_rows
from repro_torch.sparse.formats import CSR


def csr_row_nnz(a: CSR) -> torch.Tensor:
    return a.row_nnz()


class _TakeRows(torch.autograd.Function):
    """``x[clip(idx)]`` with a pluggable gather; the backward adds the
    cotangent into zeros at the clipped ids.  The kernel reads rows of a
    contiguous ``x``, so a strided ``x`` (a transpose, a column slice) is
    copied to a contiguous one first."""

    @staticmethod
    def forward(ctx, x, idx, gather):
        ctx.save_for_backward(idx)
        ctx.n_rows = x.shape[0]
        if gather == "aia":
            return gather_rows(x.contiguous(), idx)
        return x[idx.clamp(0, max(x.shape[0] - 1, 0)).long()]

    @staticmethod
    def backward(ctx, ct):
        (idx,) = ctx.saved_tensors
        n = ctx.n_rows
        safe = idx.clamp(0, max(n - 1, 0)).long()
        dx = torch.zeros((n, ct.shape[1]), dtype=ct.dtype, device=ct.device)
        return dx.index_add_(0, safe, ct), None, None


def csr_transpose(a: CSR, capacity: int | None = None) -> CSR:
    """CSR transpose via a stable sort on column ids.

    Padding slots sort to the end because their key is ``n_cols``; a
    ``capacity`` above the input's pads with zeros, one below it truncates.
    """
    cap = capacity if capacity is not None else a.capacity
    valid = a.valid_mask()
    key = torch.where(valid, a.indices, a.n_cols)
    new_rows, order = torch.sort(key, stable=True)
    new_cols = torch.where(valid, a.row_ids(), 0)[order]
    new_data = torch.where(valid, a.data, 0)[order]
    counts = torch.zeros(a.n_cols + 1, dtype=torch.int32, device=a.device)
    counts.index_add_(0, new_rows.long(), valid[order].to(torch.int32))
    indptr = torch.zeros(a.n_cols + 1, dtype=torch.int32, device=a.device)
    indptr[1:] = torch.cumsum(counts[: a.n_cols], 0, dtype=torch.int32)
    if cap == a.capacity:
        indices, data = new_cols, new_data
    elif cap > a.capacity:
        indices = torch.zeros(cap, dtype=torch.int32, device=a.device)
        data = torch.zeros(cap, dtype=a.data.dtype, device=a.device)
        indices[: a.capacity] = new_cols
        data[: a.capacity] = new_data
    else:
        indices, data = new_cols[:cap], new_data[:cap]
    return CSR(indptr, indices, data, (a.n_cols, a.n_rows))


def _segment_sum(rid: torch.Tensor, contrib: torch.Tensor,
                 n_rows: int) -> torch.Tensor:
    """Sum ``contrib`` by row id into ``n_rows`` rows (ids of ``n_rows``,
    the padding slots', land in a dropped extra row)."""
    out = torch.zeros((n_rows + 1,) + contrib.shape[1:], dtype=contrib.dtype,
                      device=contrib.device)
    return out.index_add(0, rid.long(), contrib)[:n_rows]


def csr_spmv(a: CSR, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for a dense vector x: gather + segment sum."""
    xs = x[a.indices.clamp(0, x.shape[0] - 1).long()]
    contrib = torch.where(a.valid_mask(), a.data * xs, 0)
    return _segment_sum(a.row_ids(), contrib, a.n_rows)


def csr_spmm(a: CSR, x: torch.Tensor, gather: str = "xla",
             mesh=None) -> torch.Tensor:
    """Y = A @ X for dense X (n_cols, d): the GNN aggregation primitive.

    The paper's two-level indirect access: ``indices`` selects rows of
    ``X`` (ranged access of length d), and the rows are segment-summed by
    row.  ``gather="aia"`` serves the row gather with the AIA kernel,
    ``"xla"`` with a plain take, ``"auto"`` picks the kernel on a CUDA
    device and the take on the CPU.  Differentiable in ``x`` and in
    ``a.data``.

    ``mesh`` (a sequence of devices, ``launch.sharding``) splits the
    output rows into ``row_sharding``'s contiguous ranges: each shard
    multiplies its rows of A (their slots, read off ``indptr`` in one
    small read) by its copy of X on its own device, and the blocks are
    concatenated on the merge device, where A and X must live.  Each row
    sums its slots in the same order as with ``mesh=None``, so the result
    is the same; X's gradient is the sum of the shards' gradients.
    """
    from repro_torch.core.executor import resolve_gather  # no import cycle

    if x.device != a.device:
        raise ValueError(f"A is on {a.device} but X is on {x.device}")
    gather = resolve_gather(gather, x.device)
    if mesh is not None:
        return _csr_spmm_sharded(a, x, gather, mesh)
    return _csr_spmm(a, x, gather)


def _csr_spmm(a: CSR, x: torch.Tensor, gather: str) -> torch.Tensor:
    rows_of_x = _TakeRows.apply(x, a.indices, gather)  # (cap, d)
    contrib = torch.where(a.valid_mask()[:, None],
                          a.data[:, None] * rows_of_x, 0)
    return _segment_sum(a.row_ids(), contrib, a.n_rows)


def _csr_spmm_sharded(a: CSR, x: torch.Tensor, gather: str,
                      mesh) -> torch.Tensor:
    from repro_torch.launch.sharding import (
        merge_device, replicate_to, row_sharding, shard_devices)

    devices = shard_devices(mesh)
    merge = merge_device(devices)
    if a.device != merge:
        raise ValueError(f"A is on {a.device} but the mesh's merge device "
                         f"(its first) is {merge}")
    ranges = row_sharding(devices, a.n_rows)
    cuts = torch.tensor([r0 for r0, _ in ranges] + [a.n_rows])
    slots = a.indptr[cuts.to(a.device)].tolist()
    blocks = []
    for sh, (dev, (r0, r1)) in enumerate(zip(devices, ranges)):
        lo, hi = slots[sh], slots[sh + 1]
        part = CSR(replicate_to(a.indptr[r0:r1 + 1] - lo, dev),
                   replicate_to(a.indices[lo:hi], dev),
                   replicate_to(a.data[lo:hi], dev), (r1 - r0, a.n_cols))
        y = _csr_spmm(part, replicate_to(x, dev), gather)
        blocks.append(replicate_to(y, merge))
    return torch.cat(blocks)


def _with_data(a: CSR, data: torch.Tensor) -> CSR:
    return CSR(a.indptr, a.indices, data, a.shape)


def csr_scale_rows(a: CSR, s: torch.Tensor) -> CSR:
    """diag(s) @ A."""
    sv = s[a.row_ids().clamp(0, a.n_rows - 1).long()]
    return _with_data(a, torch.where(a.valid_mask(), a.data * sv, 0))


def csr_scale_columns(a: CSR, s: torch.Tensor) -> CSR:
    """A @ diag(s)."""
    sv = s[a.indices.clamp(0, s.shape[0] - 1).long()]
    return _with_data(a, torch.where(a.valid_mask(), a.data * sv, 0))


def csr_hadamard_power(a: CSR, r: float) -> CSR:
    """Elementwise power on stored entries (MCL inflation, Alg. 6 line 12).

    The power is taken in float64 and rounded once to the data's dtype, so
    a float32 entry gets its correctly rounded power (``torch.pow`` in
    float32 misses it by an ulp on many entries at ``r`` other than 2)."""
    valid = a.valid_mask()
    d = torch.where(valid, a.data, 1.0).to(torch.float64)
    p = torch.pow(d, float(r)).to(a.data.dtype)
    return _with_data(a, torch.where(valid, p, 0))


def csr_column_sums(a: CSR) -> torch.Tensor:
    out = torch.zeros(a.n_cols, dtype=a.data.dtype, device=a.device)
    return out.index_add(0, a.indices.long(),
                         torch.where(a.valid_mask(), a.data, 0))


def csr_column_normalize(a: CSR, eps: float = 1e-12) -> CSR:
    """Make columns sum to one (MCL's ColumnNormalize)."""
    s = csr_column_sums(a)
    inv = torch.where(s > eps, 1.0 / torch.clamp(s, min=eps), 0.0)
    return csr_scale_columns(a, inv)


def csr_prune_columns(a: CSR, theta: float, k: int) -> CSR:
    """MCL Prune (Alg. 6 lines 6-10): drop entries < theta, keep the top k
    of each column.

    Keeps the CSR layout: entries are zeroed in place and the structure is
    retained.  Within a column, entries rank by value, descending; equal
    values rank in slot order.
    """
    valid = a.valid_mask()
    vals = torch.where(valid, a.data, 0)
    vals = torch.where(vals >= theta, vals, 0)
    col_key = torch.where(valid, a.indices, a.n_cols)
    # by column, then value descending, then slot: two stable sorts (zeros
    # as +0.0, since CUDA's radix sort puts -0.0 before +0.0)
    by_val = torch.sort(torch.where(vals == 0, 0.0, -vals),
                        stable=True).indices
    order = by_val[torch.sort(col_key[by_val], stable=True).indices]
    # a slot's rank in its column: its sorted position past the column's
    # first, from a count per column and an exclusive prefix sum (the
    # reference takes a running max of column starts; CUDA's cummax took
    # 1.6 s of an MCL iteration's 3.9 on an H100 at Economics' paper size)
    counts = torch.bincount(col_key, minlength=a.n_cols + 1)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(a.capacity, device=a.device)
    keep = torch.zeros(a.capacity, dtype=torch.bool, device=a.device)
    keep[order] = (pos - starts[col_key[order].long()]) < k
    return _with_data(a, torch.where(keep, vals, 0))


def csr_permute_rows(a: CSR, perm, inverse: bool = False) -> CSR:
    """Reorder rows by ``perm`` (Map from the paper's row-grouping phase).

    ``perm[i]`` = original row id placed at new position i (with
    ``inverse=True``, the new position of original row i).
    """
    perm = torch.as_tensor(perm, device=a.device).long()
    if inverse:
        perm = torch.argsort(perm, stable=True)
    counts = a.row_nnz()[perm]
    new_indptr = torch.zeros(a.n_rows + 1, dtype=torch.int32,
                             device=a.device)
    new_indptr[1:] = torch.cumsum(counts, 0, dtype=torch.int32)
    old_starts = a.indptr[:-1][perm]  # source start of each new row
    p = torch.arange(a.capacity, dtype=torch.int32, device=a.device)
    new_rid = torch.searchsorted(new_indptr, p, right=True,
                                 out_int32=True) - 1
    valid = p < new_indptr[-1]
    new_rid_c = new_rid.clamp(0, a.n_rows - 1).long()
    src = old_starts[new_rid_c] + (p - new_indptr[new_rid_c])
    src = torch.where(valid, src, 0).long()
    indices = torch.where(valid, a.indices[src], 0)
    data = torch.where(valid, a.data[src], 0)
    return CSR(new_indptr, indices, data, a.shape)
