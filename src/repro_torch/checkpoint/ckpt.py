"""Checkpointing of trees of tensors (dicts, lists, tuples, NamedTuples).

Counterpart of ``repro.checkpoint.ckpt``, with its layout (a directory a
step):

    step_<N>/
      manifest.json  -- tree structure, leaf shapes and dtypes, crc32 a file
      leaf_<i>.npy   -- the full value of leaf i (np.save)

Leaves are numbered in the reference's flattening order: a dict's keys
sorted, a list's, tuple's or NamedTuple's items in order, ``None`` no leaf.
Two departures, both because of what the card's machine has: the manifest
is JSON (the reference writes msgpack, which is not installed there), and a
bfloat16 leaf, which numpy has no dtype for, is stored as its uint16 bits
with ``"bfloat16"`` in the manifest.  A round trip is bit for bit.

* **Device-independent**: leaves are written as whole host arrays, so a
  checkpoint saved from one device, or from DTensors on a mesh (gathered,
  written by rank 0), restores onto any other device
  (``restore_checkpoint(device=)``) or any other placement
  (``restore_checkpoint(shardings=)``: a mesh of another size, other
  specs).
* **Integrity**: crc32 a leaf file, and an atomic rename of the step
  directory, so a partial save is never taken for a complete one.
* **Async**: ``AsyncCheckpointer`` copies the tree to host memory at once
  and writes it in a background thread.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import zlib
from typing import Any, List, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

MANIFEST = "manifest.json"


def tree_leaves(tree) -> List[Any]:
    """The leaves of ``tree`` in the reference's flattening order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for key in sorted(tree) for x in tree_leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [x for item in tree for x in tree_leaves(item)]
    return [tree]


def _structure(tree) -> str:
    """A readable description of the tree's structure, for the manifest."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        inner = ", ".join(_structure(x) for x in tree)
        name = type(tree).__name__
        return f"[{inner}]" if isinstance(tree, list) else f"{name}({inner})"
    return "*"


def _rebuild(target, leaves: iter):
    """``target``'s structure with its leaves taken from ``leaves`` in
    order."""
    if target is None:
        return None
    if isinstance(target, dict):
        out = {key: _rebuild(target[key], leaves) for key in sorted(target)}
        return {key: out[key] for key in target}
    if isinstance(target, list):
        return [_rebuild(x, leaves) for x in target]
    if isinstance(target, tuple):
        items = [_rebuild(x, leaves) for x in target]
        return type(target)(*items) if hasattr(target, "_fields") \
            else tuple(items)
    return next(leaves)


@dataclasses.dataclass(frozen=True)
class _Host:
    """A leaf copied to host memory: its array and the manifest's dtype."""
    arr: np.ndarray
    dtype: str


def _to_host(leaf) -> _Host:
    """A copy of a leaf in host memory: a bfloat16 tensor as its uint16
    bits, a DTensor as its full value (a collective: every rank of its
    mesh calls this)."""
    if isinstance(leaf, _Host):
        return leaf
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return _Host(t.view(torch.int16).numpy().view(np.uint16),
                         "bfloat16")
        arr = t.numpy()
    else:
        arr = np.array(leaf)
    return _Host(arr, str(arr.dtype))


def save_checkpoint(directory: str, step: int, tree: Any) -> str:
    """Synchronous atomic save; returns the final path.  A tree that holds
    DTensors is saved collectively: every rank calls this, each DTensor is
    gathered, rank 0 writes, and the ranks meet at a barrier after the
    write."""
    leaves = tree_leaves(tree)
    sharded = any(isinstance(x, DTensor) for x in leaves)
    # one leaf in host memory at a time, unless every rank must gather
    hosts = [_to_host(x) for x in leaves] if sharded else map(_to_host,
                                                              leaves)
    final = os.path.join(directory, f"step_{step}")
    if sharded and dist.get_rank() != 0:
        dist.barrier()
        return final
    _write(directory, step, tree, hosts)
    if sharded:
        dist.barrier()
    return final


def _write(directory: str, step: int, tree: Any, hosts) -> None:
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f".tmp_step_{step}")
    final = os.path.join(directory, f"step_{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    meta = []
    for i, host in enumerate(hosts):
        arr, dtype = host.arr, host.dtype
        fname = f"leaf_{i}.npy"
        np.save(os.path.join(tmp, fname), arr)
        with open(os.path.join(tmp, fname), "rb") as f:
            crc = zlib.crc32(f.read())
        meta.append({"file": fname, "shape": list(arr.shape),
                     "dtype": dtype, "crc32": crc})
    manifest = {"step": step, "treedef": _structure(tree),
                "n_leaves": len(meta), "leaves": meta,
                "format_version": 1}
    with open(os.path.join(tmp, MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic publish


def latest_step(directory: str) -> Optional[int]:
    """The largest N with a complete ``step_<N>/`` in ``directory``."""
    if not os.path.isdir(directory):
        return None
    steps = [int(name.split("_")[1]) for name in os.listdir(directory)
             if name.startswith("step_")
             and os.path.exists(os.path.join(directory, name, MANIFEST))]
    return max(steps) if steps else None


def _from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _paired(target, shardings) -> List[Any]:
    """The leaves of ``shardings`` at the places of ``target``'s leaves
    (None where ``shardings`` is None above them)."""
    if target is None:
        return []
    if isinstance(target, dict):
        return [x for key in sorted(target) for x in _paired(
            target[key], None if shardings is None else shardings[key])]
    if isinstance(target, (list, tuple)):
        return [x for i, item in enumerate(target) for x in _paired(
            item, None if shardings is None else shardings[i])]
    return [shardings]


def restore_checkpoint(directory: str, step: int, target: Any,
                       device=None, shardings=None) -> Any:
    """Restore ``step_<step>`` into the structure of ``target``.  Each leaf
    becomes a tensor on ``device``, or, when ``device`` is None, on the
    device of ``target``'s leaf (the CPU for a leaf that is not a tensor).
    ``shardings``, a tree like ``target`` whose leaves are None or a
    ``launch.sharding.NamedSharding`` (or a ``(mesh, P)`` pair), places
    those leaves as DTensors on their mesh instead (every rank of the mesh
    calls this; each keeps its shard).  A leaf whose crc32 or shape
    disagrees raises."""
    from repro_torch.launch.sharding import NamedSharding, distribute

    path = os.path.join(directory, f"step_{step}")
    with open(os.path.join(path, MANIFEST)) as f:
        manifest = json.load(f)
    flat_t = tree_leaves(target)
    if manifest["n_leaves"] != len(flat_t):
        raise ValueError(f"checkpoint has {manifest['n_leaves']} leaves, "
                         f"target {len(flat_t)}")
    flat_s = _paired(target, shardings)
    out = []
    for i, (meta, tgt, sh) in enumerate(zip(manifest["leaves"], flat_t,
                                             flat_s)):
        fpath = os.path.join(path, meta["file"])
        with open(fpath, "rb") as f:
            crc = zlib.crc32(f.read())
        if crc != meta["crc32"]:
            raise IOError(f"checksum mismatch in {fpath}")
        arr = np.load(fpath)
        if list(arr.shape) != list(np.shape(tgt)):
            raise ValueError(f"leaf {i}: checkpoint {arr.shape} vs target "
                             f"{tuple(np.shape(tgt))}")
        if sh is not None:
            sh = sh if isinstance(sh, NamedSharding) else NamedSharding(*sh)
            out.append(distribute(_from_host(arr, meta["dtype"]).to(
                sh.mesh.device_type), sh))
            continue
        dev = device if device is not None else (
            tgt.device if isinstance(tgt, torch.Tensor) else "cpu")
        out.append(_from_host(arr, meta["dtype"]).to(dev))
    return _rebuild(target, iter(out))


@dataclasses.dataclass
class AsyncCheckpointer:
    """Snapshot to host memory, then write in the background; ``wait()``
    joins the writer and raises what it raised."""

    directory: str
    _thread: Optional[threading.Thread] = None
    _error: Optional[BaseException] = None

    def save(self, step: int, tree: Any):
        self.wait()
        host_tree = _rebuild(tree,
                             iter([_to_host(x) for x in tree_leaves(tree)]))

        def _write():
            try:
                save_checkpoint(self.directory, step, host_tree)
            except BaseException as e:  # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
