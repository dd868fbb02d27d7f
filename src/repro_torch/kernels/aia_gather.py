"""The AIA indirect gather — the paper's Fig. 2 primitive.

``gather_planes`` (R = 1): ``out_p[i] = x_p[idx[i]]`` for one or two 2-d
planes ``x_p`` of equal row count (B's ELL index and value planes) and one
1-d int32 stream of row ids (A's column ids, flattened).  Ids outside
``[0, n)`` are clipped, and the stream may have any length: the CUDA kernel
(``csrc/aia_gather.cu``) takes the reference wrapper's clipping into the
kernel, needs no padding to a block multiple, and gathers both planes in
one launch.  A plane may be a view whose rows lie a pitch apart (unit
inner stride, as a column slice of a wider matrix): the kernel takes each
plane's row pitch, so such a view is gathered without a copy.  It copies
in the widest unit that divides every plane's row bytes and pitch and
every plane's and output's address (``gather_unit``: 16, 8, 4, 2 or 1
bytes), and counts each launch under ``gather_rows/<unit>``.
``gather_rows`` is its one-plane case.  Replaces
``repro.kernels.aia_gather.gather_rows`` (the Pallas scalar-prefetch DMA
kernel) and its wrapper ``gather_rows_any``.

``aia_ranged_gather`` (any R): ``out[i*R:(i+1)*R] = x[idx[i]*R : +R]``,
ranges aligned to multiples of R as the reference's BlockSpec indices are.
The reference's contract is ids in range; here an id outside
``[0, n_blocks)`` is clipped, as in the row gather.  Its entry point
(``repro_aia_ranged_gather``, its own launch count) copies by one of four
routes (``ranged_route``): a range that is a whole number of 16-byte
vectors at a 16-byte aligned, contiguous ``x`` goes to a 16-byte streaming
copy, chunk by chunk (``"v16"``); any other range to the row gather's
kernel, each id naming an R-row range, in 4-byte words (``"words"``),
2-byte units (``"u16"``) or bytes (``"bytes"``): the widest of the three
that divides the range's bytes (a row's bytes and the pitch for a strided
``x``) and ``x``'s address.  Replaces
``repro.kernels.aia_gather.aia_ranged_gather``.

Both are copies, so each kernel and its plain version agree bit for bit.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.kernels._build import library

# the row gather's copy units, widest first: route name -> bytes
UNITS = {"v16": 16, "v8": 8, "words": 4, "u16": 2, "bytes": 1}


def _check_planes(planes, idx) -> int:
    """Validate the planes' shapes against each other and every plane's
    device against ``idx``'s; return their rows."""
    if not 1 <= len(planes) <= 2:
        raise ValueError(f"expected one or two planes, got {len(planes)}")
    ops.same_device(("idx", idx),
                    *((f"plane {j}", x) for j, x in enumerate(planes)))
    n = planes[0].shape[0] if planes[0].dim() == 2 else -1
    for x in planes:
        if x.dim() != 2 or x.shape[0] != n:
            raise ValueError(f"x: expected 2-d planes of equal row count, "
                             f"got shapes {[tuple(p.shape) for p in planes]}")
    if n == 0 and idx.numel():
        raise ValueError("cannot gather rows from an empty x")
    return n


def gather_planes_plain(planes: Sequence[torch.Tensor],
                        idx: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The plain PyTorch version: a clipped row take of each plane."""
    planes = tuple(planes)
    n = _check_planes(planes, idx)
    safe = idx.clamp(0, max(n - 1, 0)).long()
    return tuple(x[safe] for x in planes)


def gather_unit(row_bytes: Sequence[int], ptrs: Sequence[int]) -> str:
    """The copy unit a CUDA row gather takes: the widest of ``"v16"``,
    ``"v8"``, ``"words"`` (4 bytes), ``"u16"`` and ``"bytes"`` that divides
    every plane's row bytes and pitch (both in ``row_bytes``) and every
    address in ``ptrs`` (each plane's and each output's)."""
    for name, unit in UNITS.items():
        if all(b % unit == 0 for b in row_bytes) and \
                all(p % unit == 0 for p in ptrs):
            return name
    raise AssertionError("a 1-byte unit divides everything")


def _pitch(x: torch.Tensor) -> int:
    """The row pitch of a 2-d plane in elements; a plane whose inner stride
    is not 1 raises (the kernel copies whole rows)."""
    if x.shape[1] > 1 and x.stride(1) != 1:
        raise ValueError(f"x: expected contiguous rows (inner stride 1), got "
                         f"strides {tuple(x.stride())}")
    pitch = x.stride(0) if x.shape[0] > 1 else x.shape[1]
    if pitch < x.shape[1]:
        raise ValueError(f"x: rows overlap (strides {tuple(x.stride())})")
    return pitch


def _gather_planes_cuda(planes, idx):
    planes = tuple(planes)
    ops.expect(idx, torch.int32, 1, "idx")
    n = _check_planes(planes, idx)
    pitches = [_pitch(x) for x in planes]
    n_idx = idx.shape[0]
    outs = tuple(torch.empty((n_idx, x.shape[1]), dtype=x.dtype,
                             device=x.device) for x in planes)
    live = [(x, o, p * x.element_size())
            for x, o, p in zip(planes, outs, pitches) if x.shape[1]]
    if n_idx == 0 or not live:
        return outs
    row_bytes = [x.shape[1] * x.element_size() for x, _, _ in live]
    route = gather_unit(row_bytes + [p for _, _, p in live],
                        [t.data_ptr() for x, o, _ in live for t in (x, o)])
    (x0, o0, p0) = live[0]
    x1, o1, p1 = live[1] if len(live) == 2 else (None, None, 0)
    rc = ops.launch_on(
        idx.device, library().repro_gather_planes, idx.data_ptr(), n_idx, n,
        x0.data_ptr(), o0.data_ptr(), row_bytes[0], p0,
        None if x1 is None else x1.data_ptr(),
        None if o1 is None else o1.data_ptr(),
        row_bytes[1] if x1 is not None else 0, p1, UNITS[route])
    ops.check_launch("gather_rows", rc, route)
    return outs


def gather_planes(planes: Sequence[torch.Tensor],
                  idx: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """``tuple(x[clip(idx)] for x in planes)`` for one or two planes of equal
    row count on ``idx``'s device: the plain version on the CPU, one kernel
    launch on CUDA (chosen by the planes' device, as ``gather_rows`` is)."""
    planes = tuple(planes)
    return ops.dispatch(lambda _, p, i: gather_planes_plain(p, i),
                        lambda _, p, i: _gather_planes_cuda(p, i),
                        planes[0] if planes else idx, planes, idx)


def gather_rows_plain(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: a clipped row take."""
    return gather_planes_plain((x,), idx)[0]


def _gather_rows_cuda(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return _gather_planes_cuda((x,), idx)[0]


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[clip(idx)]``: the plain version on the CPU, the kernel on CUDA."""
    return ops.dispatch(gather_rows_plain, _gather_rows_cuda, x, idx)


def _n_blocks(x: torch.Tensor, idx: torch.Tensor, r: int) -> int:
    if x.dim() != 2 or r < 1 or x.shape[0] % r:
        raise ValueError(f"x of shape {tuple(x.shape)} is not a whole number "
                         f"of {r}-row ranges")
    if x.shape[0] == 0 and idx.numel():
        raise ValueError("cannot gather ranges from an empty x")
    return x.shape[0] // r


def aia_ranged_gather_plain(x: torch.Tensor, idx: torch.Tensor,
                            r: int = 1) -> torch.Tensor:
    """The plain PyTorch version: a clipped take of whole ranges."""
    n_blocks = _n_blocks(x, idx, r)
    d = x.shape[1]
    ids = idx.clamp(0, max(n_blocks - 1, 0)).long()
    return x.reshape(n_blocks, r * d)[ids].reshape(idx.shape[0] * r, d)


# the ranged gather's routes other than "v16", widest first
RANGED_UNITS = {k: UNITS[k] for k in ("words", "u16", "bytes")}


def ranged_route(range_bytes: int, x_ptr: int,
                 pitch_bytes: int | None = None,
                 row_bytes: int | None = None) -> str:
    """The copy a CUDA ranged gather takes: ``"v16"`` (16-byte vectors) for
    a range of whole 16-byte vectors at a 16-byte aligned, contiguous
    ``x``; else the widest of ``"words"`` (4 bytes), ``"u16"`` and
    ``"bytes"`` that divides the range's bytes and ``x``'s address, and for
    a strided ``x`` (``pitch_bytes`` past ``row_bytes``) a row's bytes and
    the pitch in place of the range's.  The output, a fresh allocation, is
    always 16-byte aligned."""
    strided = pitch_bytes is not None and pitch_bytes != row_bytes
    if not strided and range_bytes % 16 == 0 and x_ptr % 16 == 0:
        return "v16"
    sizes = [row_bytes, pitch_bytes] if strided else [range_bytes]
    for name, unit in RANGED_UNITS.items():
        if all(b % unit == 0 for b in sizes) and x_ptr % unit == 0:
            return name
    raise AssertionError("a 1-byte unit divides everything")


def _aia_ranged_gather_cuda(x: torch.Tensor, idx: torch.Tensor,
                            r: int = 1) -> torch.Tensor:
    n_blocks = _n_blocks(x, idx, r)
    ops.expect(idx, torch.int32, 1, "idx")
    ops.same_device(("x", x), ("idx", idx))
    d = x.shape[1]
    size = x.element_size()
    pitch = _pitch(x)
    # a contiguous x is one row of R * d a range; a strided one R rows
    rows, row_bytes = (1, r * d * size) if pitch == d else (r, d * size)
    out = torch.empty((idx.shape[0] * r, d), dtype=x.dtype, device=x.device)
    if idx.shape[0] == 0 or d == 0:
        return out
    path = ranged_route(r * d * size, x.data_ptr(), pitch * size, d * size)
    unit = 16 if path == "v16" else RANGED_UNITS[path]
    with torch.cuda.device(x.device):
        rc = library().repro_aia_ranged_gather(
            x.data_ptr(), idx.data_ptr(), out.data_ptr(), n_blocks, rows,
            row_bytes, row_bytes if rows == 1 else pitch * size,
            idx.shape[0], unit, int(path == "v16"),
            torch.cuda.current_stream().cuda_stream)
    ops.check_launch("aia_ranged_gather", rc, path)
    return out


def aia_ranged_gather(x: torch.Tensor, idx: torch.Tensor,
                      r: int = 1) -> torch.Tensor:
    """``x``'s clipped ranges: the plain version on the CPU, the kernel on
    CUDA.  x: (n_blocks*R, d); idx: (N,) int32 on CUDA; out: (N*R, d)."""
    return ops.dispatch(aia_ranged_gather_plain, _aia_ranged_gather_cuda, x,
                        idx, r)


# The reference's name for its clip/pad/trim wrapper; here the kernel itself
# clips and takes any length, so the two are one function.
gather_rows_any = gather_rows
