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
  checkpoint saved from one device restores onto any other
  (``restore_checkpoint(device=)``, in place of the reference's
  ``shardings=``).
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
    bits."""
    if isinstance(leaf, _Host):
        return leaf
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
    """Synchronous atomic save; returns the final path."""
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f".tmp_step_{step}")
    final = os.path.join(directory, f"step_{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    leaves = tree_leaves(tree)
    meta = []
    for i, leaf in enumerate(leaves):
        host = _to_host(leaf)
        arr, dtype = host.arr, host.dtype
        fname = f"leaf_{i}.npy"
        np.save(os.path.join(tmp, fname), arr)
        with open(os.path.join(tmp, fname), "rb") as f:
            crc = zlib.crc32(f.read())
        meta.append({"file": fname, "shape": list(arr.shape),
                     "dtype": dtype, "crc32": crc})
    manifest = {"step": step, "treedef": _structure(tree),
                "n_leaves": len(leaves), "leaves": meta,
                "format_version": 1}
    with open(os.path.join(tmp, MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic publish
    return final


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


def restore_checkpoint(directory: str, step: int, target: Any,
                       device=None) -> Any:
    """Restore ``step_<step>`` into the structure of ``target``.  Each leaf
    becomes a tensor on ``device``, or, when ``device`` is None, on the
    device of ``target``'s leaf (the CPU for a leaf that is not a tensor).
    A leaf whose crc32 or shape disagrees raises."""
    path = os.path.join(directory, f"step_{step}")
    with open(os.path.join(path, MANIFEST)) as f:
        manifest = json.load(f)
    flat_t = tree_leaves(target)
    if manifest["n_leaves"] != len(flat_t):
        raise ValueError(f"checkpoint has {manifest['n_leaves']} leaves, "
                         f"target {len(flat_t)}")
    out = []
    for i, (meta, tgt) in enumerate(zip(manifest["leaves"], flat_t)):
        fpath = os.path.join(path, meta["file"])
        with open(fpath, "rb") as f:
            crc = zlib.crc32(f.read())
        if crc != meta["crc32"]:
            raise IOError(f"checksum mismatch in {fpath}")
        arr = np.load(fpath)
        if list(arr.shape) != list(np.shape(tgt)):
            raise ValueError(f"leaf {i}: checkpoint {arr.shape} vs target "
                             f"{tuple(np.shape(tgt))}")
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
