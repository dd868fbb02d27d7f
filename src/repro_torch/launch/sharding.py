"""Operand placement for the streamed lane (counterpart of
``repro.launch.sharding``'s ``stage_tile``; its mesh helpers are
multi-device, ROADMAP Queue A item 7)."""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch


def stage_tile(arrays: Sequence[torch.Tensor], device,
               stream: Optional["torch.cuda.Stream"] = None
               ) -> Tuple[Tuple[torch.Tensor, ...],
                          Optional["torch.cuda.Event"]]:
    """Stage one streamed A tile's host tensors on ``device``.

    On a CUDA device the tensors must be page-locked (slices of a pinned
    tensor are); each is copied with ``non_blocking=True`` on ``stream``
    (a side stream, so the copy overlaps work queued on the compute
    stream; None is the current stream), and an event recorded there
    after the copies is returned.
    The caller makes the compute stream wait on that event before the
    tile's first use and ``record_stream``s the placed tensors on it, so
    the caching allocator does not reuse their memory while work that
    reads them is in flight.  On the CPU staging is a plain copy and the
    event is None.  Returns ``(placed tensors in input order, event)``.
    """
    device = torch.device(device)
    if device.type != "cuda":
        return tuple(t.to(device, copy=True) for t in arrays), None
    for t in arrays:
        if t.numel() and not t.is_pinned():
            raise ValueError("stage_tile copies page-locked host tensors; "
                             "pin them first (Tensor.pin_memory)")
    with torch.cuda.stream(stream):
        placed = tuple(t.to(device, non_blocking=True) for t in arrays)
        ready = torch.cuda.Event()
        ready.record()
    return placed, ready
