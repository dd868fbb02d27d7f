"""Sharding: the LM substrate's named-dim rules, and shard placement for
the sharded SpGEMM executor and the streamed lane.

Counterpart of ``repro.launch.sharding``.  Its first half is the LM's:
``Shardings`` turns logical placements ("activation batch", "heads", "ffn
hidden", ...) into specs ``P`` on a single-pod ``("data", "model")`` or a
multi-pod ``("pod", "data", "model")`` mesh, and ``constrain`` applies
one: a DTensor is redistributed to the spec's placements
(``torch.distributed.tensor``; the reference's GSPMD constraint), a plain
tensor outside a mesh passes unchanged and counts in
``SHARDING_STATS["sharding_fallbacks"]``, so the same model code runs on
one device and on a mesh.

Its second half is the executor's.  There a *mesh* is a sequence of
``torch.device``s: shard ``s`` runs on ``mesh[s]``, and a device may
repeat (several logical shards on one card, or on the CPU).
``launch.mesh.make_spgemm_mesh`` gives the first ``n`` visible CUDA
devices; a caller who wants logical shards passes a list such as
``[torch.device("cuda:0")] * 4``.  The first shard's device is the merge
device: the operands live there and the result is assembled there.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.launch.mesh import current_mesh


class P(tuple):
    """A partition spec (the counterpart of ``jax.sharding.PartitionSpec``):
    one entry a tensor dim, each a mesh-dim name, a tuple of names (the dim
    split over them, major first) or None (not split); dims past the
    spec's length are not split.  A tuple of one name reads as that name,
    as jax's does.  It is a tuple, equal to the tuple of its entries."""

    def __new__(cls, *parts):
        return super().__new__(cls, tuple(
            p[0] if isinstance(p, tuple) and len(p) == 1 else p
            for p in parts))

    def __repr__(self):
        return "P(" + ", ".join(map(repr, self)) + ")"


def placements(spec, mesh, ndim: Optional[int] = None) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``: ``Shard(i)`` on the
    mesh dims that tensor dim i is split over, ``Replicate()`` on the
    others.  A name that is not a dim of the mesh raises."""
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for i, entry in enumerate(spec):
        if ndim is not None and i >= ndim and entry is not None:
            raise ValueError(f"spec {spec} splits dim {i} of a {ndim}-d "
                             f"tensor")
        for name in (entry if isinstance(entry, tuple) else (entry,)):
            if name is None:
                continue
            if name not in names:
                raise ValueError(f"spec {spec} names {name!r}, not a dim of "
                                 f"the mesh {names}")
            out[names.index(name)] = Shard(i)
    return tuple(out)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of a tree of dicts, lists and NamedTuples
    (a ``P``, a plain tuple, a tensor or a record is a leaf; None stays
    None), with the trees ``rest`` walked alongside: ``fn(leaf, *their
    subtrees at that place)``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rest))
                            for i, v in enumerate(tree)))
    return fn(tree, *rest)


def unsplit(x: torch.Tensor, dim: int, n: Optional[int] = None):
    """``x`` with its tensor dim ``dim`` no longer split: a DTensor is
    gathered over the mesh dims that split ``dim`` (with ``n``, only those
    whose size does not divide ``n``, what a view splitting ``dim`` into
    ``n`` parts needs); a plain tensor is returned as it is."""
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    pl = tuple(Replicate() if isinstance(p, Shard) and p.dim == dim
               and (n is None or n % mesh.size(i)) else p
               for i, p in enumerate(x.placements))
    return x if pl == tuple(x.placements) else x.redistribute(mesh, pl)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec: where ``distribute`` puts a tensor."""
    mesh: object
    spec: P


def distribute(x: torch.Tensor, sharding: NamedSharding) -> DTensor:
    """``x`` (the same full value on every rank) as a DTensor placed by
    ``sharding``; each rank keeps its shard.  Where every mesh dim that
    splits ``x`` has size 1, each rank's shard is ``x`` itself, and the
    DTensor shares its memory (no copy)."""
    from torch.distributed.tensor import distribute_tensor

    mesh = sharding.mesh
    pl = placements(sharding.spec, mesh, x.dim())
    if all(not isinstance(p, Shard) or mesh.size(i) == 1
           for i, p in enumerate(pl)):
        return DTensor.from_local(x, mesh, pl, run_check=False)
    return distribute_tensor(x, mesh, pl)


@dataclasses.dataclass(frozen=True)
class Shardings:
    """Logical -> physical dim rules.

    batch_axes: the mesh dims that carry data parallelism (("pod", "data"),
    ("data",), or () for the unsharded model).  model_axis: the tensor /
    expert / sequence-parallel dim (None: none).  sequence_parallel: split
    the activations' sequence dim over ``model`` between blocks.  mesh: the
    ``DeviceMesh`` (needed by the explicit-collective layers: the
    expert-parallel MoE).
    """

    batch_axes: Tuple[str, ...] = ()
    model_axis: Optional[str] = None
    sequence_parallel: bool = False
    mesh: object = None

    @property
    def batch(self):
        return tuple(self.batch_axes) if self.batch_axes else None

    def spec(self, *names) -> P:
        """names use tokens: 'b' = batch, 'm' = model, '-' = not split."""
        return P(*(self.batch if n == "b" else self.model_axis if n == "m"
                   else None for n in names))

    def act_btd(self, x):  # (batch, seq, d_model)
        if self.sequence_parallel and self.model_axis:
            return constrain(x, self.spec("b", "m", "-"))
        return constrain(x, self.spec("b", "-", "-"))

    def act_bthd(self, x):  # (batch, seq, heads, head_dim): heads on model
        return constrain(x, self.spec("b", "-", "m", "-"))

    def act_btf(self, x):  # (batch, seq, d_ff): hidden on model
        return constrain(x, self.spec("b", "-", "m"))

    def act_btv(self, x):  # logits (batch, seq, vocab): vocab on model
        return constrain(x, self.spec("b", "-", "m"))

    def act_ecd(self, x):  # MoE dispatch (experts, cap, d): experts on
        # model, capacity rows on the batch dims
        return constrain(x, self.spec("m", "b", "-"))


# ``constrain``'s no-ops on a plain tensor outside a mesh, counted so that a
# silent degradation stays observable
SHARDING_STATS = {"sharding_fallbacks": 0}


def constrain(x, spec):
    """``x`` redistributed to ``spec``'s placements on its mesh (the
    ambient mesh of ``launch.mesh.use_mesh``, when one is set, must be that
    mesh).  A plain tensor outside a mesh is returned unchanged and counted
    in ``SHARDING_STATS["sharding_fallbacks"]``; a plain tensor under a mesh
    raises, since its placement is unknown."""
    mesh = current_mesh()
    if isinstance(x, DTensor):
        if mesh is not None and mesh != x.device_mesh:
            raise ValueError("constrain: the tensor lies on another mesh "
                             "than the ambient one")
        target = placements(spec, x.device_mesh, x.dim())
        if tuple(x.placements) == target:
            return x
        return x.redistribute(x.device_mesh, target)
    if mesh is None:
        SHARDING_STATS["sharding_fallbacks"] += 1
        return x
    raise TypeError("constrain: a plain tensor under a mesh; place it with "
                    "launch.sharding.distribute first")


UNSHARDED = Shardings()


def replicating(sh: Shardings):
    """The context in which a model step under ``sh`` runs: under a mesh,
    DTensor's implicit replication, so a plain tensor made inside the step
    (positions, masks, zeros) meets the DTensors as a replicated one; a
    no-op context otherwise."""
    if sh.mesh is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def make_shardings(mesh, sequence_parallel: bool = False) -> Shardings:
    """The rules of ``mesh``: its ``pod`` and ``data`` dims carry the
    batch, its ``model`` dim the tensor parallelism."""
    names = tuple(mesh.mesh_dim_names)
    return Shardings(batch_axes=tuple(n for n in ("pod", "data")
                                      if n in names),
                     model_axis="model" if "model" in names else None,
                     sequence_parallel=sequence_parallel, mesh=mesh)


# ---------------------------------------------------------------------------
# SpGEMM executor shard placement
# ---------------------------------------------------------------------------

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
