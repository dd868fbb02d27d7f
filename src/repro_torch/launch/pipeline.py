"""GPipe-style pipeline parallelism over a mesh dim (counterpart of
``repro.launch.pipeline``).

Each rank of the ``pipe`` dim holds one stage's weights; microbatches flow
stage to stage around a ring of point-to-point sends
(``torch.distributed.batch_isend_irecv`` on the dim's process group, the
reference's ``ppermute``).  The schedule is GPipe's fill and drain: M + S
- 1 ticks for M microbatches over S stages (a bubble of (S - 1) / (M + S -
1)).  Every rank computes every tick, as the reference's SPMD program
does; what a stage computes during the fill and the drain is never read.
The last stage's outputs reach every rank by one all-reduce, the other
ranks adding zeros, so the result is exact.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.launch.mesh import mesh_sizes
from repro_torch.launch.sharding import tree_map


def _stage_weights(a, stage: int):
    """This stage's slice of a stacked (S, ...) leaf: the local shard of a
    DTensor split over the pipe dim, or row ``stage`` of a full tensor."""
    if isinstance(a, DTensor):
        local = a.to_local()
        if local.shape[0] != 1:
            raise ValueError(f"a stage weight split over the pipe dim must "
                             f"hold one stage a rank, got {local.shape[0]}")
        return local[0]
    return a[stage]


def pipeline_apply(mesh, stage_weights, microbatches, stage_fn: Callable,
                   n_microbatches: int, axis: str = "pipe"):
    """Run ``stage_fn(w, h)`` as an S-stage pipeline over the mesh dim
    ``axis`` (S its size).

    stage_weights: a tree whose leaves are stacked (S, ...) on the stage
    axis (full on every rank, or DTensors split over ``axis``).
    microbatches: (M, ...) inputs, the same on every rank (a plain tensor
    or a replicated DTensor).  Returns the (M, ...) outputs, the same on
    every rank, as a plain tensor.
    """
    s_stages = mesh_sizes(mesh)[axis]
    stage = mesh.get_local_rank(axis)
    group = mesh.get_group(axis)
    m = n_microbatches
    w = tree_map(lambda a: _stage_weights(a, stage), stage_weights)
    x_all = microbatches.full_tensor() if isinstance(microbatches, DTensor) \
        else microbatches
    nxt = dist.get_global_rank(group, (stage + 1) % s_stages)
    prv = dist.get_global_rank(group, (stage - 1) % s_stages)
    last = stage == s_stages - 1
    state = torch.zeros_like(x_all[0])
    outputs = torch.zeros_like(x_all)
    for t in range(m + s_stages - 1):
        out = stage_fn(w, x_all[min(t, m - 1)] if stage == 0 else state)
        m_out = t - (s_stages - 1)
        if last and 0 <= m_out < m:
            outputs[m_out] = out
        if s_stages == 1:
            state = out
            continue
        state = torch.empty_like(out)
        for req in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, out.contiguous(), nxt, group),
                dist.P2POp(dist.irecv, state, prv, group)]):
            req.wait()
    if s_stages > 1:
        dist.all_reduce(outputs, group=group)
    return outputs
