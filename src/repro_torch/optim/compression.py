"""Int8 gradient compression for the cross-pod all-reduce: per-tensor
symmetric int8 with a float32 scale.

Counterpart of ``repro.optim.compression``: ``int8_compress``,
``int8_decompress`` and ``compressed_psum``, the all-reduce whose payload
is the int8 levels (quantise, an integer sum, dequantise) over a dim of the
ambient mesh (``launch.mesh.use_mesh``), on ``torch.distributed`` process
groups.  Rounding is half to even (``torch.round``, as ``jnp.round``).
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def int8_compress(x: torch.Tensor):
    """(q, scale): ``q = clip(round(x / scale), -127, 127)`` in int8,
    ``scale = max|x| / 127`` (1 for an all-zero ``x``), float32."""
    x32 = x.to(torch.float32)
    amax = torch.max(torch.abs(x32))
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_decompress(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)


def compressed_psum(x: torch.Tensor, axis_name: str, dtype=None
                    ) -> torch.Tensor:
    """The sum of every rank's ``x`` over the mesh dim ``axis_name`` of the
    ambient mesh, through int8 levels: an all-reduce MAX of the local
    ``max|x|`` gives one shared scale ``amax / 127`` (1 when it is 0), so
    no rank's levels overflow; each rank rounds ``x / scale`` to
    [-127, 127], the levels are summed in int32 (no overflow for fewer
    than 2^24 ranks), and the sum times the scale comes back in ``dtype``
    (default ``x``'s).  ``x`` is each rank's own (plain) tensor, as under
    the reference's ``shard_map``."""
    from repro_torch.launch.mesh import mesh_group

    group = mesh_group(axis_name)
    dtype = dtype or x.dtype
    x32 = x.to(torch.float32)
    amax = torch.max(torch.abs(x32))
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int32)
    dist.all_reduce(q, op=dist.ReduceOp.SUM, group=group)
    return (q.to(torch.float32) * scale).to(dtype)
