"""Meshes: the SpGEMM executor's list of devices, and the LM substrate's
named ``DeviceMesh``es (counterpart of ``repro.launch.mesh``).

The sharded SpGEMM executor's mesh is a list of ``torch.device``s, one a
shard (``launch.sharding``); logical shards, several on one device, are an
explicit list such as ``[torch.device("cuda:0")] * 4``
(``make_spgemm_mesh``).

The LM substrate's mesh is a ``torch.distributed`` ``DeviceMesh`` with
named dims: single-pod ``(16, 16)`` over ``("data", "model")``, multi-pod
``(2, 16, 16)`` over ``("pod", "data", "model")``.  Building one needs a
default process group of the mesh's size (``init_process_group``; torch's
fake process group traces a production mesh in one process, as
``launch.dryrun`` does).  ``AbstractMesh`` carries the names and sizes
alone, which is all the spec layer (``launch.specs``) reads.  ``use_mesh``
sets the ambient mesh that ``launch.sharding.constrain`` and
``optim.compressed_psum`` read.  Importing this module touches no device
and no process group.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

_AMBIENT: List[object] = []


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's dim names and sizes with no devices behind them (the
    counterpart of ``jax.sharding.AbstractMesh``): ``shape`` and
    ``mesh_dim_names`` read as a ``DeviceMesh``'s do."""
    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]

    def __post_init__(self):
        if len(self.shape) != len(self.mesh_dim_names):
            raise ValueError(f"shape {self.shape} and names "
                             f"{self.mesh_dim_names} differ in length")


def mesh_sizes(mesh) -> Dict[str, int]:
    """``{dim name: size}`` of a ``DeviceMesh`` or an ``AbstractMesh``."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def compat_make_mesh(shape, axes, devices=None, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` with dims named ``axes`` over the
    default process group's ranks: all of them in rank order
    (``init_device_mesh``), or the global ranks ``devices`` laid out in
    ``shape`` (a sub-mesh).  ``device_type`` is ``"cuda"`` unless the
    caller asks for ``"cpu"`` (gloo) or ``"meta"``."""
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if devices is None:
        return init_device_mesh(device_type, shape, mesh_dim_names=axes)
    ranks = torch.as_tensor(list(devices), dtype=torch.int64)
    return DeviceMesh(device_type, ranks.reshape(shape), mesh_dim_names=axes)


def production_mesh_shape(multi_pod: bool = False
                          ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """The production mesh's shape and dim names."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The (16, 16) single-pod or (2, 16, 16) multi-pod ``DeviceMesh``; it
    needs a default process group of 256 or 512 ranks."""
    shape, axes = production_mesh_shape(multi_pod)
    return compat_make_mesh(shape, axes, device_type=device_type)


def make_test_mesh(shape=(2, 2), axes=("data", "model"),
                   device_type: str = "cuda"):
    """A small mesh for multi-process tests (gloo on the CPU with
    ``device_type="cpu"``) and for one card (``(1, 1)``)."""
    return compat_make_mesh(shape, axes, device_type=device_type)


def make_spgemm_mesh(n_devices: Optional[int] = None) -> List[torch.device]:
    """The first ``n_devices`` visible CUDA devices (all of them by
    default), one shard each.  Raises ``ValueError`` when fewer are
    visible; it never returns CPU devices."""
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = visible if n_devices is None else int(n_devices)
    if not 1 <= n <= visible:
        raise ValueError(
            f"requested {n} shard devices but only {visible} CUDA devices "
            "are visible; for logical shards pass an explicit list, e.g. "
            "[torch.device('cuda:0')] * 4")
    return [torch.device("cuda", i) for i in range(n)]


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the ambient mesh inside the ``with`` block (nested
    blocks stack)."""
    _AMBIENT.append(mesh)
    try:
        yield mesh
    finally:
        _AMBIENT.pop()


def current_mesh():
    """The ambient mesh of the innermost ``use_mesh``, or None."""
    return _AMBIENT[-1] if _AMBIENT else None


def mesh_group(axis_name: str, mesh=None):
    """The process group of the mesh dim ``axis_name`` of ``mesh`` (default:
    the ambient mesh); raises when there is no such mesh or dim."""
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        raise ValueError(f"axis {axis_name!r}: no mesh (enter one with "
                         f"launch.mesh.use_mesh)")
    names: Sequence[str] = mesh.mesh_dim_names or ()
    if axis_name not in names:
        raise ValueError(f"axis {axis_name!r} is not a dim of the mesh "
                         f"{tuple(names)}")
    return mesh.get_group(axis_name)
