"""Sparse matrix formats with a static (padded) capacity.

Counterpart of ``repro.sparse.formats``, with the same conventions:

* ``CSR``: ``indptr[(n_rows+1,)] int32``; ``indices[(cap,)] int32`` and
  ``data[(cap,)]`` padded beyond ``indptr[-1]`` with ``indices = 0`` and
  ``data = 0``.  Validity of slot ``p`` is ``p < indptr[-1]``; row ids are
  recovered with ``row_ids()``.
* ``ELL``: ``indices[(n_rows, k_cap)]`` padded with ``-1``;
  ``data[(n_rows, k_cap)]`` padded with ``0``.  Per-row occupancy is
  ``(indices >= 0).sum(-1)``.

The capacity (``indices.shape[0]``, ``k_cap``) is kept separate from the
occupancy (``indptr[-1]``, ``indices >= 0``), so a result can be sized from
a bound without reading its true size back to the host.

Host-side constructors compact on the host with numpy and place the result
on ``device`` (default ``"cuda"``; tests pass ``"cpu"``).  Converters keep
their operands' device and never read data back to the host.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


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


# ---------------------------------------------------------------------------
# Host-side constructors
# ---------------------------------------------------------------------------

def _place(x: np.ndarray, device) -> torch.Tensor:
    # a copy, so the CSR never shares memory with the caller's array
    return torch.from_numpy(np.array(x, order="C")).to(device)


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
    return CSR(_place(indptr.astype(np.int32), device),
               _place(indices.astype(np.int32), device),
               _place(data, device), (n, m))


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


def csr_from_dense(x, capacity: int | None = None, device="cuda") -> CSR:
    """Dense (n, m) -> CSR.  Host-side helper (numpy compaction)."""
    x = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    rows, cols = np.nonzero(x)
    return _csr_from_sorted(rows, cols, x[rows, cols], x.shape, capacity,
                            device)


def csr_from_coo(rows, cols, vals, shape, capacity: int | None = None,
                 device="cuda") -> CSR:
    """COO triplets (host numpy) -> CSR, sorting by (row, col) and merging
    duplicates (summed in ``np.add.at`` order, as the reference does)."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    vals = np.asarray(vals)
    n, m = shape
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    if len(rows):
        key = rows * m + cols
        uniq, inv = np.unique(key, return_inverse=True)
        merged = np.zeros(len(uniq), vals.dtype)
        np.add.at(merged, inv, vals)
        rows, cols, vals = uniq // m, uniq % m, merged
    return _csr_from_sorted(rows, cols, vals, (n, m), capacity, device)


# ---------------------------------------------------------------------------
# Device-side converters
# ---------------------------------------------------------------------------

def csr_to_dense(a: CSR) -> torch.Tensor:
    """CSR -> dense (n, m) on the CSR's device."""
    out = torch.zeros((a.n_rows + 1, a.n_cols), dtype=a.data.dtype,
                      device=a.device)
    valid = a.valid_mask()
    # padding slots have rid == n_rows -> added into a dropped row
    out.index_put_((a.row_ids().long(), a.indices.long()),
                   torch.where(valid, a.data, 0), accumulate=True)
    return out[: a.n_rows]


def csr_to_ell(a: CSR, k_cap: int) -> ELL:
    """CSR -> ELL with per-row capacity ``k_cap`` (entries past it drop)."""
    n = a.n_rows
    rid = a.row_ids()
    p = torch.arange(a.capacity, dtype=torch.int32, device=a.device)
    within = p - a.indptr[rid.clamp(0, n).long()]  # slot's place in its row
    valid = a.valid_mask() & (within < k_cap)
    srow = torch.where(valid, rid, n).long()
    scol = torch.where(valid, within, 0).long()
    indices = torch.full((n + 1, k_cap), -1, dtype=torch.int32,
                         device=a.device)
    indices.index_put_((srow, scol), torch.where(valid, a.indices, -1))
    data = torch.zeros((n + 1, k_cap), dtype=a.data.dtype, device=a.device)
    data.index_put_((srow, scol), torch.where(valid, a.data, 0))
    return ELL(indices[:n], data[:n], a.shape)


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
