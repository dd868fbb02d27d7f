"""Sparse matrix formats with a static (padded) capacity.

Counterpart of ``repro.sparse.formats``, with the same conventions:

* ``CSR``: ``indptr[(n_rows+1,)] int32``; ``indices[(cap,)] int32`` and
  ``data[(cap,)]`` padded beyond ``indptr[-1]`` with ``indices = 0`` and
  ``data = 0``.  Validity of slot ``p`` is ``p < indptr[-1]``; row ids are
  recovered with ``row_ids()``.
* ``ELL``: ``indices[(n_rows, k_cap)]`` padded with ``-1``;
  ``data[(n_rows, k_cap)]`` padded with ``0``.  Per-row occupancy is
  ``(indices >= 0).sum(-1)``.
* ``BSR``: block-CSR; ``indptr[(n_brows+1,)]``, ``indices[(bcap,)]`` block
  column ids (``0`` padded), ``blocks[(bcap, bs_r, bs_c)]``.
* ``TopKRows``: the paper's Eq. (2) sparsified activation, exactly ``k``
  entries per row (``values[(n, k)]``, ``indices[(n, k)]``), no padding.

The capacity (``indices.shape[0]``, ``k_cap``) is kept separate from the
occupancy (``indptr[-1]``, ``indices >= 0``), so a result can be sized from
a bound without reading its true size back to the host.

Host-side constructors compact on the host and place the result on
``device`` (default ``"cuda"``; tests pass ``"cpu"``).  ``from_numpy``
carries a host array of any dtype across, bfloat16 (``ml_dtypes``, as JAX
hands it out) included.  Converters keep their operands' device and never
read data back to the host.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels.segment_sum import index_sum, segment_sum_plain


@dataclasses.dataclass(frozen=True)
class CSR:
    """Compressed sparse row with static capacity ``indices.shape[0]``."""

    indptr: torch.Tensor
    indices: torch.Tensor
    data: torch.Tensor
    shape: Tuple[int, int]

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

    @property
    def capacity(self) -> int:
        return self.indices.shape[0]

    @property
    def device(self) -> torch.device:
        return self.indptr.device

    @property
    def nnz(self) -> torch.Tensor:
        """Occupancy as a 0-d device tensor (reading it is a host sync)."""
        return self.indptr[-1]

    def row_ids(self) -> torch.Tensor:
        """Row id of every slot (capacity,); padding slots get ``n_rows``."""
        p = torch.arange(self.capacity, dtype=torch.int32, device=self.device)
        rid = torch.searchsorted(self.indptr, p, right=True, out_int32=True) - 1
        return torch.where(p < self.nnz, rid, self.n_rows)

    def valid_mask(self) -> torch.Tensor:
        return torch.arange(self.capacity, device=self.device) < self.nnz

    def row_nnz(self) -> torch.Tensor:
        return (self.indptr[1:] - self.indptr[:-1]).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class ELL:
    """Padded row-major sparse rows: fixed ``k_cap`` slots per row."""

    indices: torch.Tensor  # (n_rows, k_cap) int32, -1 padded
    data: torch.Tensor  # (n_rows, k_cap)
    shape: Tuple[int, int]

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

    @property
    def k_cap(self) -> int:
        return self.indices.shape[1]

    def valid_mask(self) -> torch.Tensor:
        return self.indices >= 0

    def row_nnz(self) -> torch.Tensor:
        return self.valid_mask().sum(-1).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class BSR:
    """Block-CSR with dense ``(bs_r, bs_c)`` blocks."""

    indptr: torch.Tensor  # (n_brows + 1,) int32
    indices: torch.Tensor  # (bcap,) int32 block-column ids, 0-padded
    blocks: torch.Tensor  # (bcap, bs_r, bs_c)
    shape: Tuple[int, int]  # element shape (rows, cols)

    @property
    def block_shape(self) -> Tuple[int, int]:
        return (self.blocks.shape[1], self.blocks.shape[2])

    @property
    def n_brows(self) -> int:
        return self.indptr.shape[0] - 1

    @property
    def n_bcols(self) -> int:
        return self.shape[1] // self.blocks.shape[2]

    @property
    def device(self) -> torch.device:
        return self.indptr.device

    @property
    def nnzb(self) -> torch.Tensor:
        """Occupied blocks as a 0-d device tensor (reading it is a host sync)."""
        return self.indptr[-1]


@dataclasses.dataclass(frozen=True)
class TopKRows:
    """Eq. (2) of the paper: exactly-k-per-row sparse activations."""

    values: torch.Tensor  # (n, k)
    indices: torch.Tensor  # (n, k) int32
    shape: Tuple[int, int]  # (n, d_full)

    @property
    def k(self) -> int:
        return self.values.shape[1]

    def to_dense(self) -> torch.Tensor:
        """(n, d_full) with each kept value added at its index (a repeated
        index accumulates in slot order, as the reference's
        ``.at[].add``)."""
        n, d = self.shape
        slot = self.indices.long() + torch.arange(
            0, n * d, d, device=self.indices.device)[:, None]
        return _add_at(n * d, slot.view(-1), self.values.reshape(-1)) \
            .view(n, d)


def _add_at(n_out: int, ids: torch.Tensor, values: torch.Tensor):
    """``zeros(n_out, *values.shape[1:])`` with ``values[i]`` added at
    ``ids[i]`` in stream order, as the reference's ``.at[ids].add`` (ids
    >= ``n_out``, the padding's, left out):
    every floating dtype through ``kernels.segment_sum.index_sum``
    (CUDA's ``index_add_`` and ``index_put_(accumulate=True)`` add in no
    fixed order, and so does the CPU's ``index_put_`` on long runs of one
    index); integers, whose sums do not depend on the order, by
    ``index_put_(accumulate=True)``."""
    w = values.reshape(values.shape[0], -1)
    if w.dtype.is_floating_point:
        out = index_sum(ids, w, n_out)
    else:
        out = torch.zeros((n_out + 1, w.shape[1]), dtype=w.dtype,
                          device=w.device).index_put_(
                              (ids.clamp(max=n_out),), w,
                              accumulate=True)[:n_out]
    return out.view(n_out, *values.shape[1:])


# ---------------------------------------------------------------------------
# Host-side constructors
# ---------------------------------------------------------------------------

def from_numpy(x, device="cuda") -> torch.Tensor:
    """A host array -> a tensor on ``device``, bit for bit.

    ``torch.from_numpy`` refuses numpy's ``bfloat16`` (the ``ml_dtypes`` type
    that ``np.asarray`` gives for a JAX bf16 array), so such an array goes
    across as its 16-bit patterns and is viewed as ``torch.bfloat16``.  The
    result is a copy: it never shares memory with ``x``.
    """
    x = np.array(x, order="C")
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(x).to(device)


def csr_from_arrays(indptr, indices, data, shape, device="cuda") -> CSR:
    """Host arrays (e.g. another package's CSR read out with numpy) -> CSR.

    ``indptr``/``indices`` become int32, ``data`` keeps its dtype, and the
    capacity is ``len(indices)``: padding beyond ``indptr[-1]`` carries over
    as it is.
    """
    indptr = np.asarray(indptr)
    indices = np.asarray(indices)
    data = np.asarray(data)
    n, m = (int(s) for s in shape)
    if indptr.shape != (n + 1,):
        raise ValueError(f"indptr has shape {indptr.shape}, expected ({n + 1},)")
    if indices.shape != data.shape or indices.ndim != 1:
        raise ValueError(
            f"indices {indices.shape} and data {data.shape} must be equal 1-d")
    return CSR(from_numpy(indptr.astype(np.int32), device),
               from_numpy(indices.astype(np.int32), device),
               from_numpy(data, device), (n, m))


def _csr_from_sorted(rows, cols, vals, shape, capacity, device) -> CSR:
    n, m = shape
    nnz = len(rows)
    cap = capacity if capacity is not None else max(nnz, 1)
    if nnz > cap:
        raise ValueError(f"capacity {cap} < nnz {nnz}")
    indptr = np.zeros(n + 1, np.int32)
    np.add.at(indptr[1:], rows, 1)
    indptr = np.cumsum(indptr).astype(np.int32)
    indices = np.zeros(cap, np.int32)
    data = np.zeros(cap, vals.dtype)
    indices[:nnz] = cols
    data[:nnz] = vals
    return csr_from_arrays(indptr, indices, data, (n, m), device)


def _host(x):
    """A tensor or array -> (a numpy array, the dtype the result keeps).  A
    bfloat16 tensor, which numpy cannot hold, comes across as float32 (an
    exact widening) with ``torch.bfloat16`` to cast back to; anything else
    keeps its own dtype (None)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.float().numpy(), torch.bfloat16
        return x.numpy(), None
    return np.asarray(x), None


def _keep(a: CSR, dtype) -> CSR:
    """``a`` with its data cast back to ``dtype`` (None: as it is); exact,
    since the values came from ``dtype`` and were only moved."""
    if dtype is None:
        return a
    return CSR(a.indptr, a.indices, a.data.to(dtype), a.shape)


def csr_from_dense(x, capacity: int | None = None, device="cuda") -> CSR:
    """Dense (n, m) -> CSR.  Host-side helper (numpy compaction); a
    bfloat16 tensor goes through float32 on the host and keeps its
    dtype."""
    x, dtype = _host(x)
    rows, cols = np.nonzero(x)
    return _keep(_csr_from_sorted(rows, cols, x[rows, cols], x.shape,
                                  capacity, device), dtype)


def csr_from_coo(rows, cols, vals, shape, capacity: int | None = None,
                 device="cuda") -> CSR:
    """COO triplets (host numpy) -> CSR, sorting by (row, col) and merging
    duplicates (summed in ``np.add.at`` order, as the reference does)."""
    rows = np.asarray(_host(rows)[0], np.int64)
    cols = np.asarray(_host(cols)[0], np.int64)
    vals, dtype = _host(vals)
    n, m = shape
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    if len(rows):
        key = rows * m + cols
        uniq, inv = np.unique(key, return_inverse=True)
        if dtype is None:
            merged = np.zeros(len(uniq), vals.dtype)
            np.add.at(merged, inv, vals)
        else:  # each add rounded to bfloat16, in np.add.at's order
            merged = segment_sum_plain(
                torch.from_numpy(inv.reshape(-1)),
                torch.from_numpy(vals).to(dtype)[:, None],
                len(uniq))[:, 0].float().numpy()
        rows, cols, vals = uniq // m, uniq % m, merged
    return _keep(_csr_from_sorted(rows, cols, vals, (n, m), capacity,
                                  device), dtype)


def bsr_from_arrays(indptr, indices, blocks, shape, device="cuda") -> BSR:
    """Host arrays (e.g. the reference's BSR read out with numpy) -> BSR.

    ``indptr``/``indices`` become int32, ``blocks`` keeps its dtype
    (bfloat16 included), and the capacity is ``len(indices)``.
    """
    indptr = np.asarray(indptr)
    indices = np.asarray(indices)
    blocks = np.asarray(blocks)
    n, m = (int(s) for s in shape)
    if blocks.ndim != 3 or indices.shape != blocks.shape[:1]:
        raise ValueError(f"indices {indices.shape} and blocks {blocks.shape} "
                         f"must be (bcap,) and (bcap, bs_r, bs_c)")
    br, bc = blocks.shape[1:]
    if br == 0 or bc == 0 or n % br or m % bc:
        raise ValueError(f"shape {(n, m)} is not a whole number of "
                         f"{(br, bc)} blocks")
    if indptr.shape != (n // br + 1,):
        raise ValueError(f"indptr has shape {indptr.shape}, expected "
                         f"({n // br + 1},)")
    return BSR(from_numpy(indptr.astype(np.int32), device),
               from_numpy(indices.astype(np.int32), device),
               from_numpy(blocks, device), (n, m))


def topk_rows_from_arrays(values, indices, shape, device="cuda") -> TopKRows:
    """Host arrays (e.g. the reference's TopKRows) -> TopKRows."""
    values = np.asarray(values)
    indices = np.asarray(indices)
    n, d = (int(s) for s in shape)
    if values.shape != indices.shape or values.ndim != 2 \
            or values.shape[0] != n:
        raise ValueError(f"values {values.shape} and indices {indices.shape} "
                         f"must both be ({n}, k)")
    return TopKRows(from_numpy(values, device),
                    from_numpy(indices.astype(np.int32), device), (n, d))


def bsr_from_dense(x, block_shape: Tuple[int, int],
                   capacity: int | None = None, device="cuda") -> BSR:
    """Dense -> BSR keeping every block with a nonzero, in row-major block
    order.  Host-side helper: ``x`` (a numpy array, bfloat16 included, or
    a tensor) is compacted on the host."""
    x = x.cpu() if isinstance(x, torch.Tensor) else from_numpy(x, "cpu")
    n, m = x.shape
    br, bc = block_shape
    if n % br or m % bc:
        raise ValueError(f"shape {(n, m)} is not a whole number of "
                         f"{(br, bc)} blocks")
    nbr, nbc = n // br, m // bc
    blocks4 = x.reshape(nbr, br, nbc, bc).permute(0, 2, 1, 3)
    rows, cols = torch.nonzero((blocks4 != 0).flatten(2).any(-1),
                               as_tuple=True)
    nnzb = rows.shape[0]
    cap = capacity if capacity is not None else max(nnzb, 1)
    if nnzb > cap:
        raise ValueError(f"capacity {cap} < nnzb {nnzb}")
    indptr = torch.zeros(nbr + 1, dtype=torch.int32)
    indptr[1:] = torch.bincount(rows, minlength=nbr).cumsum(0)
    indices = torch.zeros(cap, dtype=torch.int32)
    indices[:nnzb] = cols.to(torch.int32)
    blocks = torch.zeros((cap, br, bc), dtype=x.dtype)
    blocks[:nnzb] = blocks4[rows, cols]
    return BSR(indptr.to(device), indices.to(device), blocks.to(device),
               (n, m))


# ---------------------------------------------------------------------------
# Device-side converters
# ---------------------------------------------------------------------------

def bsr_to_dense(a: BSR) -> torch.Tensor:
    """BSR -> dense on the BSR's device (padding blocks are dropped)."""
    br, bc = a.block_shape
    nbr, nbc = a.n_brows, a.n_bcols
    cap = a.indices.shape[0]
    p = torch.arange(cap, dtype=torch.int32, device=a.device)
    rid = torch.searchsorted(a.indptr, p, right=True, out_int32=True) - 1
    valid = p < a.nnzb
    rid = torch.where(valid, rid, nbr)  # padding: past the last block
    out = _add_at(nbr * nbc, rid.long() * nbc + a.indices.long(),
                  torch.where(valid[:, None, None], a.blocks, 0))
    return out.view(nbr, nbc, br, bc).permute(0, 2, 1, 3).reshape(a.shape)


def csr_to_dense(a: CSR) -> torch.Tensor:
    """CSR -> dense (n, m) on the CSR's device (repeated entries add in
    slot order)."""
    n, m = a.shape
    valid = a.valid_mask()
    # padding slots have rid == n_rows: past the last entry, left out
    out = _add_at(n * m, a.row_ids().long() * m + a.indices.long(),
                  torch.where(valid, a.data, 0))
    return out.view(n, m)


def ell_from_dense(x, k_cap: int | None = None, device="cuda") -> ELL:
    """Dense (n, m) -> ELL with ``k_cap`` slots a row (default: the widest
    row's nonzeros; a row's nonzeros past ``k_cap`` drop).  Host-side
    helper (numpy compaction; a bfloat16 tensor goes through float32 and
    keeps its dtype)."""
    x, dtype = _host(x)
    n, m = x.shape
    nz = x != 0
    per_row = nz.sum(axis=1)
    k = k_cap if k_cap is not None else max(int(per_row.max(initial=0)), 1)
    rows, cols = np.nonzero(nz)
    within = np.arange(len(rows)) - np.repeat(
        np.cumsum(per_row) - per_row, per_row)
    keep = within < k
    indices = np.full((n, k), -1, np.int32)
    data = np.zeros((n, k), x.dtype)
    indices[rows[keep], within[keep]] = cols[keep]
    data[rows[keep], within[keep]] = x[rows[keep], cols[keep]]
    data = from_numpy(data, device)
    return ELL(from_numpy(indices, device),
               data if dtype is None else data.to(dtype), (n, m))


def ell_to_dense(a: ELL) -> torch.Tensor:
    """ELL -> dense (n, m) on the ELL's device (entries of one column in a
    row add up in slot order)."""
    n, m = a.shape
    mask = a.valid_mask()
    slot = a.indices.long() + torch.arange(0, n * m, m,
                                           device=mask.device)[:, None]
    slot = torch.where(mask, slot, n * m)  # padding: past the end, left out
    out = _add_at(n * m, slot.view(-1),
                  torch.where(mask, a.data, 0).reshape(-1))
    return out.view(n, m)


def _ell_slots(a: CSR, k_cap: int):
    """(ELL row, ELL slot, kept) of each of ``a``'s capacity slots; a slot
    not kept (padding, or past ``k_cap`` in its row) goes to row n_rows."""
    n = a.n_rows
    rid = a.row_ids()
    p = torch.arange(a.capacity, dtype=torch.int32, device=a.device)
    within = p - a.indptr[rid.clamp(0, n).long()]  # slot's place in its row
    valid = a.valid_mask() & (within < k_cap)
    return (torch.where(valid, rid, n).long(),
            torch.where(valid, within, 0).long(), valid)


def csr_to_ell(a: CSR, k_cap: int) -> ELL:
    """CSR -> ELL with per-row capacity ``k_cap`` (entries past it drop)."""
    n = a.n_rows
    srow, scol, valid = _ell_slots(a, k_cap)
    indices = torch.full((n + 1, k_cap), -1, dtype=torch.int32,
                         device=a.device)
    indices.index_put_((srow, scol), torch.where(valid, a.indices, -1))
    data = torch.zeros((n + 1, k_cap), dtype=a.data.dtype, device=a.device)
    data.index_put_((srow, scol), torch.where(valid, a.data, 0))
    return ELL(indices[:n], data[:n], a.shape)


def ell_values_folded(a: CSR, k_cap: int,
                      data_batch: torch.Tensor) -> torch.Tensor:
    """The ELL value planes of a batch of value sets on ``a``'s structure,
    folded row-major: ``(n_rows, batch * k_cap)``, member i's row in
    columns ``[i * k_cap, (i + 1) * k_cap)``.  ``data_batch`` is
    ``(batch, capacity)``.  One contiguous plane, so a row gather serves
    every member's B rows in one copy."""
    n = a.n_rows
    batch = data_batch.shape[0]
    srow, scol, valid = _ell_slots(a, k_cap)
    out = torch.zeros((n + 1, batch, k_cap), dtype=data_batch.dtype,
                      device=a.device)
    out[srow, :, scol] = torch.where(valid[:, None], data_batch.t(), 0)
    return out[:n].reshape(n, batch * k_cap)


def ell_to_csr(a: ELL, capacity: int | None = None) -> CSR:
    """ELL -> CSR (capacity defaults to ``n_rows * k_cap``)."""
    n = a.n_rows
    cap = capacity if capacity is not None else n * a.k_cap
    dev = a.indices.device
    counts = a.row_nnz()
    indptr = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    indptr[1:] = torch.cumsum(counts, 0, dtype=torch.int32)
    # compact valid entries left within each row, then scatter to flat offsets
    _, order = torch.sort((~a.valid_mask()).to(torch.uint8), dim=1,
                          stable=True)
    cidx = torch.gather(a.indices, 1, order)
    cdat = torch.gather(a.data, 1, order)
    within = torch.arange(a.k_cap, dtype=torch.int32, device=dev)[None, :]
    ok = within < counts[:, None]
    flat_pos = torch.where(ok, indptr[:-1][:, None] + within, cap).long()
    indices = torch.zeros(cap + 1, dtype=torch.int32, device=dev)
    indices[flat_pos] = torch.where(ok, cidx, 0)
    data = torch.zeros(cap + 1, dtype=a.data.dtype, device=dev)
    data[flat_pos] = torch.where(ok, cdat, 0)
    return CSR(indptr, indices[:cap], data[:cap], a.shape)
