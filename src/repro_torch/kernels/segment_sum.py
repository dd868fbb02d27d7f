"""Sorted segment sum in the reference's order of adds.

``segment_sum(ids, values, n_out, order=None)``: for non-decreasing int64
``ids`` of shape (N,) and ``values`` of shape (N, W) or (B, N, W), float32,
float64, bfloat16 or float16, ``out[..., s, :] = ((0 + v[i0]) + v[i1]) + ...`` over the
entries ``i0 < i1 < ...`` with ``ids[i] == s``, where ``v[i]`` is
``values[..., order[i], :]`` when a permutation ``order`` (N,) is given and
``values[..., i, :]`` otherwise; a segment with no entry is 0.  The result
has shape (..., n_out, W).  Ids are >= 0; ids >= ``n_out`` are left out,
so a CSR's padding slots (one run at the end, 175 M slots of a planned
capacity in MCL) cost nothing.  With ``skip`` > 0 every segment s with ``s
% skip == skip - 1`` is 0 and is not summed: the sort engine's rows of
``skip`` segments end in an overflow segment (padding and truncated slots)
that it drops.  Leaving out a zero changes no sum's bits: a sum that
starts from +0.0 is never -0.0, and ``x + 0.0 == x`` for every other
``x``.

That is the order in which the reference's ``.at[ids].add`` adds (XLA's
scatter-add takes its updates one at a time, in update order): the sort
engine (``repro.core.phases.sort_unique``) and the CSR primitives
(``repro.sparse.ops``: ``_take_rows``' backward, ``csr_spmv``, ``csr_spmm``,
``csr_column_sums``).  On the CPU the plain version, ``zeros(...)
.index_add_(-2, ids, values)``, adds in index order too; on CUDA
``index_add_`` and ``scatter_add_`` add with atomics, in an order that
changes from run to run, so the port's sums there go through the CUDA
kernel ``csrc/segment_sum.cu`` instead: no atomics, each column of a run
added left to right by one thread (for W = 1 found at its first entry;
for W > 1 each segment's bounds marked once in a scratch buffer, short
runs packed several to a warp, and runs longer than ``long_run()`` a
block each, their rows staged through shared memory), every add
``__fadd_rn`` / ``__dadd_rn``; bfloat16 and float16 values are added with
each add rounded to their type, as the CPU's ``index_add_`` and XLA's
scatter-add add them, so a low-precision sum is the CPU's bits too.  Any
number of value sets is taken (the kernel walks its grid's y dimension in
slices of 65,535).  It
replaces no Pallas kernel: the reference leaves these sums to XLA.  Each
launch counts under ``segment_sum``.

``index_sum(idx, values, n_out)`` is ``zeros(n_out, W).index_add_(0, idx,
values)`` for ids in any order (ids >= ``n_out`` left out), each output's
terms added in stream order:
the plain version on the CPU; on CUDA a stable sort of ``idx`` and the
kernel reading the values through the sort's permutation, which adds each
run in the same stream order.

Both are differentiable in ``values``: the backward gathers the output's
gradient at ``ids`` (a gather adds nothing, so it is deterministic), and
scatters it back through ``order`` where one was given.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.kernels._build import library, source_constants

FLOATS = (torch.float32, torch.float64, torch.bfloat16, torch.float16)


def long_run() -> int:
    """The kernel's ``kLongRun``: for W > 1, runs longer than it take the
    block route (read from ``csrc/segment_sum.cu``)."""
    return source_constants("segment_sum.cu")["kLongRun"]


def work_len(n: int, n_out: int, width: int, long_run: int) -> int:
    """The int64 scratch the kernel takes for W > 1 with ``kLongRun`` =
    ``long_run``: each segment's run bounds, the long runs' count and
    their list; 0 for one column."""
    if width == 1:
        return 0
    return 2 * n_out + 2 + (n // (long_run + 1) if long_run > 0 else 0)


def _check(ids, values, order, skip) -> None:
    if skip < 0:
        raise ValueError(f"segment_sum: skip {skip} < 0")
    if ids.dim() != 1 or values.dim() not in (2, 3) \
            or values.shape[-2] != ids.shape[0]:
        raise ValueError(f"segment_sum: ids (N,) and values (N, W) or (B, "
                         f"N, W) expected, got {tuple(ids.shape)} and "
                         f"{tuple(values.shape)}")
    if order is not None and tuple(order.shape) != tuple(ids.shape):
        raise ValueError(f"segment_sum: order {tuple(order.shape)} is not "
                         f"ids' shape {tuple(ids.shape)}")


def _add_rounded(ids, values, n_out):
    """``zeros(...).index_add_(-2, ids, values)`` for bfloat16 and float16
    values with every add rounded to their type, in index order: the CPU's
    ``index_add_`` sums such runs in float32 and rounds once.  Each step
    adds the next entry of every run at once (its rank in its run after a
    stable sort), so a step's ids are distinct."""
    ids, order = torch.sort(ids, stable=True)
    pos = torch.arange(ids.shape[0], device=ids.device)
    start = torch.ones_like(ids, dtype=torch.bool)
    start[1:] = ids[1:] != ids[:-1]
    rank = pos - torch.cummax(torch.where(start, pos, 0), 0).values
    # the entries by rank, so that each step's are one slice
    by_rank = torch.sort(rank, stable=True).indices
    ids, order = ids[by_rank], order[by_rank]
    ends = torch.bincount(rank).cumsum(0).tolist() if ids.numel() else []
    acc = values.new_zeros((*values.shape[:-2], n_out, values.shape[-1]),
                           dtype=torch.float32)
    lo = 0
    for hi in ends:
        seg = ids[lo:hi]
        acc[..., seg, :] = (acc[..., seg, :] + values.index_select(
            -2, order[lo:hi]).float()).to(values.dtype).float()
        lo = hi
    return acc.to(values.dtype)


def segment_sum_plain(ids: torch.Tensor, values: torch.Tensor, n_out: int,
                      order: torch.Tensor | None = None,
                      skip: int = 0) -> torch.Tensor:
    """The plain PyTorch version: ``index_add_`` into zeros, which adds in
    index order on the CPU (``_add_rounded`` for bfloat16 and float16, so
    that each add rounds to their type as the reference's does).  ``ids``
    need not be sorted here."""
    _check(ids, values, order, skip)
    if order is not None:
        values = values.index_select(-2, order)
    keep = ids < n_out
    if skip:  # skipped segments are left out
        keep &= ids % skip != skip - 1
    if not bool(keep.all()):  # ids past the end are left out
        ids, values = ids[keep], values[..., keep, :]
    if values.dtype in (torch.bfloat16, torch.float16):
        return _add_rounded(ids, values, n_out)
    out = values.new_zeros((*values.shape[:-2], n_out, values.shape[-1]))
    if values.shape[-1] == 1:  # ATen's index_add_ is fastest on the last dim
        out[..., 0].index_add_(-1, ids, values[..., 0])
    else:
        out.index_add_(-2, ids, values)
    return out


def _segment_sum_cuda(ids, values, n_out, order, skip=0):
    _check(ids, values, order, skip)
    ops.expect(ids, torch.int64, 1, "ids")
    if order is not None:
        ops.expect(order, torch.int64, 1, "order")
        ops.same_device(("ids", ids), ("order", order))
    if values.dtype not in FLOATS:
        raise ValueError(f"segment_sum: floating-point values expected, "
                         f"got {values.dtype}")
    ops.same_device(("values", values), ("ids", ids))
    values = values.contiguous()
    batch = values.shape[0] if values.dim() == 3 else 1
    n, width = values.shape[-2], values.shape[-1]
    out = torch.empty((*values.shape[:-2], n_out, width), dtype=values.dtype,
                      device=values.device)
    if out.numel() == 0:
        return out
    work = torch.empty(work_len(n, n_out, width, long_run()),
                       dtype=torch.int64, device=values.device)
    rc = ops.launch_on(
        values.device, library().repro_segment_sum, ids.data_ptr(),
        values.data_ptr(), None if order is None else order.data_ptr(),
        out.data_ptr(), work.data_ptr() if work.numel() else None, n, n_out,
        width, skip, batch, ops.DTYPE_CODES[values.dtype])
    ops.check_launch("segment_sum", rc)
    return out


class _SegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, ids, n_out, order, skip):
        ctx.save_for_backward(ids, order)
        ctx.n_out, ctx.skip = n_out, skip
        return ops.dispatch(segment_sum_plain, _segment_sum_cuda, ids,
                            values, n_out, order, skip)

    @staticmethod
    def backward(ctx, grad):
        ids, order = ctx.saved_tensors
        n_out, skip = ctx.n_out, ctx.skip
        # a value left out (past the end, or in a skipped segment) moves
        # nothing: it reads a zero row put after the gradient's
        at = ids.clamp(max=n_out)
        if skip:
            at = torch.where(ids % skip == skip - 1, n_out, at)
        zero = grad.new_zeros((*grad.shape[:-2], 1, grad.shape[-1]))
        g = torch.cat([grad, zero], -2).index_select(-2, at)
        if order is not None:
            g = torch.empty_like(g).index_copy_(-2, order, g)
        return g, None, None, None, None


def segment_sum(ids: torch.Tensor, values: torch.Tensor, n_out: int,
                order: torch.Tensor | None = None,
                skip: int = 0) -> torch.Tensor:
    """Segment sums of ``values`` by sorted ``ids`` in ascending index
    order (through ``order`` where given; every ``skip``-th segment left
    at 0): the plain version on the CPU, the kernel on CUDA."""
    return _SegmentSum.apply(values, ids, n_out, order, skip)


def index_sum(idx: torch.Tensor, values: torch.Tensor,
              n_out: int) -> torch.Tensor:
    """``zeros(n_out, W).index_add_(0, idx, values)`` (values (N, W) or (B,
    N, W)) with each output's terms added in stream order: ``index_add_``
    on the CPU; on CUDA a stable sort of ``idx`` (in its own dtype) and
    ``segment_sum`` through the sort's permutation."""
    return ops.dispatch(segment_sum_plain, index_sum_sorted, idx, values,
                        n_out)


def index_sum_sorted(idx: torch.Tensor, values: torch.Tensor,
                     n_out: int) -> torch.Tensor:
    """``index_sum``'s CUDA route on any device: the ids sorted stably, the
    runs summed through the sort's permutation."""
    ids, order = torch.sort(idx, stable=True)
    return segment_sum(ids.long(), values, n_out, order)
