"""Shard placement for the sharded SpGEMM executor and the streamed lane.

Counterpart of the executor half of ``repro.launch.sharding``.  In the port
a *mesh* is a sequence of ``torch.device``s: shard ``s`` runs on
``mesh[s]``, and a device may repeat (several logical shards on one card,
or on the CPU).  ``launch.mesh.make_spgemm_mesh`` gives the first ``n``
visible CUDA devices; a caller who wants logical shards passes a list such
as ``[torch.device("cuda:0")] * 4``.  The first shard's device is the merge
device: the operands live there and the result is assembled there.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

MESH_HELP = ("a mesh is a non-empty sequence of torch.device (or device "
             "strings) of one device type, e.g. [torch.device('cuda:0')] * 4 "
             "or launch.mesh.make_spgemm_mesh()")


def _as_device(d) -> torch.device:
    if not isinstance(d, (torch.device, str)):
        raise TypeError(f"mesh entry {d!r} is not a device; {MESH_HELP}")
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def shard_devices(mesh) -> list:
    """The device of every shard, in shard order.

    ``mesh=None`` is ``[None]``: one logical shard on the operands' own
    device, so the single- and multi-shard paths are one loop.  Anything
    that is not a sequence of devices raises ``TypeError``; a mesh whose
    devices are not all of one type raises ``ValueError``.
    """
    if mesh is None:
        return [None]
    if isinstance(mesh, (torch.device, str)) or not isinstance(
            mesh, Sequence):
        raise TypeError(f"mesh={mesh!r} is not a mesh; {MESH_HELP}")
    devices = [_as_device(d) for d in mesh]
    if not devices:
        raise ValueError(f"the mesh is empty; {MESH_HELP}")
    types = {d.type for d in devices}
    if len(types) > 1:
        raise ValueError(f"the mesh mixes device types {sorted(types)}; "
                         f"{MESH_HELP}")
    return devices


def replicate_to(x: torch.Tensor, device) -> torch.Tensor:
    """``x`` on ``device``: the identity when it is already there (so
    logical shards on one device share one copy) or ``device`` is None,
    else a copy queued without waiting (``non_blocking``)."""
    if device is None or x.device == device:
        return x
    return x.to(device, non_blocking=True)


def merge_device(devices):
    """The device that holds the operands and assembles the result: the
    first shard's (None on the unsharded path)."""
    return devices[0] if devices else None


def place_operand_block(b_idx: torch.Tensor, b_val: torch.Tensor, rows,
                        device) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """One shard's footprint block of B's ELL planes.

    ``rows`` are the sorted unique B rows the shard's chunks read (host
    ints).  Only those rows of ``b_idx``/``b_val`` go to ``device``, with
    an int32 ``remap`` of length ``n_rows(B)`` from a global row id to its
    row in the block (``-1`` for a row the block does not hold, which the
    remapped gathers mask as padding).  Returns ``(idx_block, val_block,
    remap)``, all on ``device``.
    """
    rows_np = np.asarray(rows, np.int64)
    remap = np.full(int(b_idx.shape[0]), -1, np.int32)
    remap[rows_np] = np.arange(len(rows_np), dtype=np.int32)
    sel = torch.from_numpy(rows_np).to(b_idx.device)
    return (replicate_to(b_idx.index_select(0, sel), device),
            replicate_to(b_val.index_select(0, sel), device),
            replicate_to(torch.from_numpy(remap).to(b_idx.device), device))


def row_sharding(mesh, n_rows: int) -> List[Tuple[int, int]]:
    """The contiguous half-open row ranges ``[r0, r1)`` that a mesh splits
    ``n_rows`` rows into, one a shard in shard order: ``ceil(n_rows /
    n_shards)`` rows each, the last ones short or empty (the split of dim 0
    over the mesh that the reference's ``NamedSharding`` gives)."""
    k = len(shard_devices(mesh))
    per = -(-int(n_rows) // k)
    return [(min(s * per, n_rows), min((s + 1) * per, n_rows))
            for s in range(k)]


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
    event is None.  Under a mesh the tile goes to the merge device, and
    the tile's ``execute_plan`` fans it out to the shards.  Returns
    ``(placed tensors in input order, event)``.
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
