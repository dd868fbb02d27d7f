"""Allocation + accumulation phase engines (paper Algorithms 2/3/5).

Each engine consumes one group-chunk of rows with static shapes: ``a_cap``
= max nnz(A-row) in the group, ``kb_cap`` = max nnz(B-row) globally,
``table_cap`` = the group's Table-I hash capacity.

* ``*_hash`` — Algorithm 4's linear-probing table per row, filled in
  stream order (``kernels.hash_accum``: the CUDA kernel on a CUDA tensor,
  the lockstep plain version on the CPU).
* ``*_sort`` — the vectorised sort + segment-sum engine: the same columns,
  counts and sums, bit for bit: each row's runs are added in stream order
  by ``kernels.segment_sum`` (``index_add_`` on the CPU, the sorted
  segment-sum kernel on CUDA, where ``scatter_add_`` would add with
  atomics in no fixed order).

Every function keeps its operands' device and reads nothing back to the
host, so a chunk is dispatched without a sync.  The value streams may carry
a leading batch axis (same-pattern operands, values differ): the keys are
computed once and only the values broadcast over the batch.
"""
from __future__ import annotations

import torch

# the module, not its names: kernels.hash_accum imports core.hashtable, so
# importing it first runs this module while it is still loading
from repro_torch.kernels import hash_accum
from repro_torch.kernels.segment_sum import segment_sum

INT_MAX = 2**31 - 1


# ---------------------------------------------------------------------------
# Intermediate-product enumeration (the two-level indirection itself)
# ---------------------------------------------------------------------------

def gather_group_rows(indptr, indices, data, rows, a_cap: int):
    """Gather the A entries of ``rows`` (-1 = padding row) into (R, a_cap)
    tensors padded with -1 / 0.  ``data`` may be a batch ``(B, cap)`` of
    value sets on the one structure: the values come back (B, R, a_cap)."""
    n_rows = indptr.shape[0] - 1
    safe_rows = rows.clamp(0, max(n_rows - 1, 0)).long()
    starts = indptr[safe_rows]
    counts = indptr[safe_rows + 1] - starts
    offs = torch.arange(a_cap, dtype=torch.int32, device=rows.device)[None, :]
    ok = (offs < counts[:, None]) & (rows >= 0)[:, None]
    pos = torch.where(ok, starts[:, None] + offs, 0).long()
    cols = torch.where(ok, indices[pos], -1)
    vals = torch.where(ok, data[..., pos], 0)
    return cols, vals


def combine_products(cols_a, vals_a, bi, bv):
    """Form intermediate products from already-gathered B rows.

    cols_a, vals_a: (R, a_cap) padded with -1 / 0 — the rows' A entries.
    bi, bv:         (R, a_cap, kb) the gathered B rows (padding rows may
                    hold anything: they are masked by ``cols_a < 0``).
    Returns keys (R, a_cap*kb) int32 (-1 padded) and vals (same shape); each
    product is rounded on its own, as the reference forms it.  Batched:
    ``vals_a`` (B, R, a_cap) and ``bv`` (B, R, a_cap, kb) give contiguous
    vals (B, R, a_cap*kb) over the same keys.
    """
    r, a_cap = cols_a.shape
    kb = bi.shape[2]
    valid = (cols_a >= 0)[:, :, None] & (bi >= 0)
    keys = torch.where(valid, bi, -1).reshape(r, a_cap * kb)
    vals = torch.where(valid, vals_a[..., None] * bv, 0)
    return keys, vals.reshape(*vals.shape[:-3], r, a_cap * kb).contiguous()


def remap_columns(cols, remap):
    """Global A-column ids -> rows of a shard's footprint block of B.

    ``remap`` is the block's (n_rows(B),) int32 map, ``-1`` for a row the
    block does not hold.  Padding (``cols < 0``) stays -1, and so does a
    column the block lacks, which ``combine_products`` then masks."""
    safe = cols.clamp(0, remap.shape[0] - 1).long()
    return torch.where(cols >= 0, remap[safe], -1)


def enumerate_products(cols_a, vals_a, b_idx, b_val):
    """Per-row intermediate products through a plain row take of B's ELL.

    ``b_idx[cols_a]`` is the AIA ranged indirect access (``rpt_B[col_A[j]]``
    → row of B); the executor's ``gather="aia"`` serves it with the kernel
    in ``kernels.aia_gather`` instead.
    """
    safe = cols_a.clamp(0, b_idx.shape[0] - 1).long()
    return combine_products(cols_a, vals_a, b_idx[safe], b_val[safe])


# ---------------------------------------------------------------------------
# Hash engine (Algorithms 2/3 allocation; Algorithms 4/5 accumulation)
# ---------------------------------------------------------------------------

def allocate_hash(keys, table_cap: int):
    """uniqueCount per row (Algorithms 2/3 output).  keys: (R, ip_cap)."""
    zeros = torch.zeros(keys.shape, dtype=torch.float32, device=keys.device)
    return hash_accum.hash_accumulate(keys, zeros, table_cap)[2]


def accumulate_hash(keys, vals, table_cap: int):
    """(cols, vals, counts) per row, column-sorted (Algorithm 5 output)."""
    return hash_accum.hash_accumulate_sorted(keys, vals, table_cap, table_cap)


def fused_hash_sorted(keys, vals, table_cap: int, out_cap: int):
    """Algorithms 2/3/5 in one pass: the product stream goes straight into
    the per-row table and the column-sorted rows come back trimmed to
    ``out_cap``, which the caller sizes from an a-priori bound (uniqueCount
    <= min(IP, n_cols) per row).  A batch of value streams (B, R, L) is
    inserted once per member over the same keys (one kernel launch a
    member on CUDA); every member has the same cols and counts, so member
    0's are returned beside the (B, R, out_cap) values."""
    if vals.dim() == 2:
        return hash_accum.hash_accumulate_sorted(keys, vals, table_cap,
                                                 out_cap)
    outs = [hash_accum.hash_accumulate_sorted(keys, v, table_cap, out_cap)
            for v in vals]
    return outs[0][0], torch.stack([o[1] for o in outs]), outs[0][2]


# ---------------------------------------------------------------------------
# Sort engine (vectorised; the same columns and counts)
# ---------------------------------------------------------------------------

def _sorted_starts(keys):
    skey = torch.where(keys >= 0, keys, INT_MAX)
    sk, order = torch.sort(skey, dim=1, stable=True)
    valid = sk != INT_MAX
    is_start = torch.ones_like(valid)
    is_start[:, 1:] = sk[:, 1:] != sk[:, :-1]
    return sk, order, valid, is_start & valid


def sort_unique(keys, vals, out_cap: int):
    """Per-row stable sort + segment-sum + compaction.  keys: (R, ip_cap);
    vals: (R, ip_cap), or a batch (B, R, ip_cap) of value streams over the
    same keys (sorted once, every member's values summed in its order).

    Returns (cols, vals, counts) with column-sorted rows padded to
    ``out_cap`` (-1 / 0); vals keep the batch axis.
    """
    r = keys.shape[0]
    lead = vals.shape[:-2]
    sk, order, valid, is_start = _sorted_starts(keys)
    sv = torch.gather(vals, -1, order.expand(*lead, -1, -1))
    ur = torch.cumsum(is_start, dim=1, dtype=torch.int32) - 1  # unique rank
    counts = torch.where(valid, ur + 1, 0).amax(dim=1).to(torch.int32)
    # each slot's segment, row-major over (R, out_cap + 1): non-decreasing,
    # since a row's slots are sorted and its invalid and truncated ones go
    # to its last segment, out_cap, which is dropped (and not summed)
    seg = torch.where(valid & (ur < out_cap), ur, out_cap).long()
    seg += torch.arange(0, r * (out_cap + 1), out_cap + 1,
                        device=keys.device)[:, None]
    out_vals = segment_sum(
        seg.view(-1), torch.where(valid, sv, 0).reshape(*lead, -1, 1),
        r * (out_cap + 1), skip=out_cap + 1).view(*lead, r, out_cap + 1)
    start_tgt = torch.where(is_start & (ur < out_cap), ur, out_cap).long()
    out_cols = torch.full((r, out_cap + 1), -1, dtype=torch.int32,
                          device=keys.device)
    out_cols.scatter_(1, start_tgt, torch.where(is_start, sk, -1))
    return out_cols[:, :out_cap], out_vals[..., :out_cap], counts


def allocate_sort(keys):
    """uniqueCount per row via sort (no value accumulation)."""
    return _sorted_starts(keys)[3].sum(dim=1, dtype=torch.int32)


def accumulate_sort(keys, vals, out_cap: int):
    return sort_unique(keys, vals, out_cap)


# ---------------------------------------------------------------------------
# Device-side CSR reassembly epilogue
# ---------------------------------------------------------------------------

def reassemble_device(idx_buf, dat_buf, cols, vals, counts, starts):
    """Scatter one chunk's accumulated rows into the final CSR buffers.

    idx_buf, dat_buf: (cap + 1,) int32 / dtype — the output CSR's index and
                      value buffers, with one trailing *sink* slot; updated
                      in place and returned.  Batched: dat_buf (B, cap + 1)
                      and vals (B, R_pad, out_cap), one structure.
    cols, vals:       (R_pad, out_cap) the chunk's column-sorted rows.
    counts:           (R_pad,) int32 per-row occupancy; padding rows are 0.
    starts:           (R_pad,) CSR start offset of each row.

    Slots past a row's count are sent to the sink slot, which also retires
    padding rows; the caller keeps ``[:cap]``.
    """
    sink = idx_buf.shape[0] - 1
    offs = torch.arange(cols.shape[1], dtype=torch.int64,
                        device=cols.device)[None, :]
    pos = torch.where(offs < counts[:, None], starts[:, None].long() + offs,
                      sink)
    idx_buf[pos] = cols
    dat_buf[..., pos] = vals
    return idx_buf, dat_buf


# ---------------------------------------------------------------------------
# Sharded epilogue: shard-local CSR segments + destination-mapped merge
# ---------------------------------------------------------------------------

def _exclusive_cumsum(x):
    return torch.cumsum(x, 0, dtype=torch.int32) - x


def reassemble_segment(seg_idx, seg_dat, dest, off, cols, vals, counts,
                       fin_starts):
    """Pack one chunk's rows densely into its shard's segment and record
    each slot's position in the final CSR buffers (the shard-local half of
    the sharded epilogue, on the shard's device).

    seg_idx, seg_dat: (seg_cap + 1,) the segment, with one trailing sink
                      slot; batched, seg_dat (B, seg_cap + 1) and vals
                      (B, R_pad, out_cap) over one structure.
    dest:             (seg_cap + 1,) int32 final position of each slot; it
                      starts at the final capacity (a sentinel the merge
                      drops), and the sink slot keeps it.
    off:              () int32 slots packed so far (a device scalar).
    cols, vals:       (R_pad, out_cap) the chunk's column-sorted rows.
    counts:           (R_pad,) int32 per-row occupancy (padding rows 0).
    fin_starts:       (R_pad,) int32 final CSR start of each row.

    Empty slots, and slots past ``seg_cap``, go to the sink slot.  Updates
    the buffers in place; returns them and the new offset.
    """
    sink = seg_idx.shape[0] - 1
    offs = torch.arange(cols.shape[1], dtype=torch.int32,
                        device=cols.device)[None, :]
    pos = (off + _exclusive_cumsum(counts))[:, None] + offs
    ok = (offs < counts[:, None]) & (pos < sink)
    pos = torch.where(ok, pos, sink).long()
    seg_idx[pos] = cols
    seg_dat[..., pos] = vals
    dest[pos] = torch.where(ok, fin_starts[:, None] + offs, dest[sink])
    return seg_idx, seg_dat, dest, off + counts.sum(dtype=torch.int32)


# One structure for every member: the value scatter broadcasts over B.
reassemble_segment_batched = reassemble_segment


def merge_segments(idx_buf, dat_buf, seg_idx, seg_dat, dest):
    """Scatter one shard's packed segment into the final CSR buffers (on
    the merge device), which carry one trailing sink slot: positions at or
    past the capacity, the segment's unused slots, land there.  Updates in
    place and returns the buffers; ``dat_buf`` may be batched (B, cap + 1)
    with ``seg_dat`` (B, seg_cap + 1)."""
    sink = idx_buf.shape[0] - 1
    pos = torch.where(dest < sink, dest, sink).long()
    idx_buf[pos] = seg_idx
    dat_buf[..., pos] = seg_dat
    return idx_buf, dat_buf


merge_segments_batched = merge_segments


def merge_segments_host(idx_buf, dat_buf, seg_idx, seg_dat, dest):
    """Scatter one compact CSR segment into host (numpy) output buffers at
    positions ``dest`` — the streamed lane's merge of a finished tile.
    Positions at or past the buffers' capacity are dropped.  Mutates and
    returns ``idx_buf``/``dat_buf``."""
    keep = dest < idx_buf.shape[0]
    idx_buf[dest[keep]] = seg_idx[keep]
    dat_buf[dest[keep]] = seg_dat[keep]
    return idx_buf, dat_buf


# The reference's batched names: the functions above take a leading batch
# axis of value sets on one structure themselves (one structural gather,
# one key tensor, one scatter position for every member).

def gather_group_rows_batched(indptr, indices, data_b, rows, a_cap: int):
    """``gather_group_rows`` with ``data_b`` (B, cap): (cols (R, a_cap),
    vals (B, R, a_cap))."""
    return gather_group_rows(indptr, indices, data_b, rows, a_cap)


def combine_products_batched(cols_a, vals_a_b, bi, bv_b):
    """``combine_products`` with ``vals_a_b`` (B, R, a_cap) and ``bv_b``
    (B, R, a_cap, kb): keys (R, a_cap*kb), vals (B, R, a_cap*kb)."""
    return combine_products(cols_a, vals_a_b, bi, bv_b)


def reassemble_device_batched(idx_buf, dat_buf_b, cols, vals_b, counts,
                              starts):
    """``reassemble_device`` with ``dat_buf_b`` (B, cap + 1) and ``vals_b``
    (B, R_pad, out_cap): the port's buffers keep their trailing sink slot,
    where the reference drops an out-of-range write."""
    return reassemble_device(idx_buf, dat_buf_b, cols, vals_b, counts,
                             starts)
