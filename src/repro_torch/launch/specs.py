"""Shape, dtype and spec stand-ins for every (arch x shape) cell.

Counterpart of ``repro.launch.specs``.  Each function returns
``ShapeDtypeStruct`` records (shape, dtype, ``P``) in the tree the step
takes, and allocates nothing: parameter and cache shapes come from the
model's inits traced under ``FakeTensorMode``
(``models.transformer.param_shapes``).  ``launch.dryrun`` turns them into
meta DTensors.  Parameters take ``param_specs`` (tensor parallelism over
``model``), the AdamW moments additionally split over ``data`` (ZeRO-1),
decode caches split their sequence dim over ``model`` (flash-decoding).
A mesh is anything with ``mesh_dim_names`` and ``shape``: a
``DeviceMesh`` or a ``launch.mesh.AbstractMesh``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.launch.mesh import mesh_sizes
from repro_torch.launch.sharding import P, tree_map
from repro_torch.models import transformer as tf


@dataclasses.dataclass(frozen=True)
class ShapeDtypeStruct:
    """A tensor's shape, dtype and spec, with no storage."""
    shape: Tuple[int, ...]
    dtype: torch.dtype
    spec: P

    def meta(self) -> torch.Tensor:
        """An empty tensor of this shape and dtype on the meta device."""
        return torch.empty(self.shape, dtype=self.dtype, device="meta")


def _batch_axes(mesh) -> Tuple[str, ...]:
    return tuple(n for n in ("pod", "data") if n in mesh.mesh_dim_names)


def _data_size(mesh) -> int:
    sizes = mesh_sizes(mesh)
    n = 1
    for a in _batch_axes(mesh):
        n *= sizes[a]
    return n


def _model_size(mesh) -> int:
    return mesh_sizes(mesh).get("model", 1)


def _bspec(mesh, b: int):
    ba = _batch_axes(mesh)
    return ba if (ba and b % _data_size(mesh) == 0) else None


def batch_specs(cfg: ArchConfig, shape: ShapeSpec, mesh) -> Dict[str, Any]:
    """The training / prefill batch: tokens and labels, and the config's
    stub inputs, split over the batch dims when they divide the batch."""
    b, s = shape.global_batch, shape.seq_len
    bspec = _bspec(mesh, b)
    out = {"tokens": ShapeDtypeStruct((b, s), torch.int32, P(bspec, None)),
           "labels": ShapeDtypeStruct((b, s), torch.int32, P(bspec, None))}
    if cfg.frontend == "vision_stub":
        out["vision_embeds"] = ShapeDtypeStruct(
            (b, cfg.vision_patches, cfg.d_model), torch.bfloat16,
            P(bspec, None, None))
    if cfg.encoder_layers:
        out["frames"] = ShapeDtypeStruct(
            (b, cfg.encoder_seq, cfg.d_model), torch.bfloat16,
            P(bspec, None, None))
    return out


def param_sds(cfg: ArchConfig, mesh):
    """(the parameters' ``ShapeDtypeStruct`` tree, their spec tree)."""
    shapes = tf.param_shapes(cfg)
    shape_tree = tf._tree(cfg, lambda k: ShapeDtypeStruct(
        shapes[k][0], shapes[k][1], P()))
    specs = tf.param_specs(cfg, shape_tree, model_size=_model_size(mesh))
    sds = tree_map(lambda s, sp: dataclasses.replace(s, spec=sp),
                   shape_tree, specs)
    return sds, specs


def train_state_sds(cfg: ArchConfig, mesh, zero1: bool = True):
    """The ``TrainState``: parameters, and AdamW's float32 moments keyed by
    tree path, split over the last batch dim as well (ZeRO-1: the first
    dim not yet split that the dim's size divides)."""
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.train.step import TrainState

    p_sds, _ = param_sds(cfg, mesh)
    data_axes = _batch_axes(mesh)
    data_axis = data_axes[-1] if data_axes else None
    dsize = mesh_sizes(mesh)[data_axis] if data_axis else 1

    def moment(s: ShapeDtypeStruct) -> ShapeDtypeStruct:
        parts = list(s.spec) + [None] * (len(s.shape) - len(s.spec))
        if zero1 and data_axis is not None:
            for i, pp in enumerate(parts):
                if pp is None and s.shape[i] % dsize == 0 \
                        and s.shape[i] >= dsize:
                    parts[i] = data_axis
                    break
            return ShapeDtypeStruct(s.shape, torch.float32, P(*parts))
        return ShapeDtypeStruct(s.shape, torch.float32, s.spec)

    flat = tf.flat_params(p_sds)
    moments = {k: moment(s) for k, s in flat.items()}
    scalar = ShapeDtypeStruct((), torch.int32, P())
    return TrainState(step=scalar, params=p_sds,
                      opt=AdamWState(step=scalar, mu=moments,
                                     nu=dict(moments)))


@functools.lru_cache(maxsize=None)
def _cache_shapes(cfg: ArchConfig, b: int, s: int):
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        cache = tf.init_decode_cache(cfg, b, s, device="cpu")
        return {k: (tuple(t.shape), t.dtype) for k, t in cache.items()}


def cache_specs(cfg: ArchConfig, shape: ShapeSpec, mesh) -> Dict[str, Any]:
    """The decode caches, their sequence dims split over ``model``; a dim
    that a split's size does not divide is not split."""
    b, s = shape.global_batch, shape.seq_len
    bspec = _bspec(mesh, b)
    ms = _model_size(mesh)
    seq_ax = "model" if (ms > 1 and s % ms == 0) else None
    rules = {
        "pos": P(),
        "k": P(None, bspec, seq_ax, None, None),
        "v": P(None, bspec, seq_ax, None, None),
        "latent": P(None, bspec, seq_ax, None),
        "krope": P(None, bspec, seq_ax, None),
        "p_latent": P(None, bspec, seq_ax, None),
        "p_krope": P(None, bspec, seq_ax, None),
        "cross_k": P(None, bspec, None, None, None),
        "cross_v": P(None, bspec, None, None, None),
        "ssm": P(None, bspec, "model" if ms > 1 else None, None, None),
        "conv": P(None, bspec, None, None),
        "shared_k": P(None, bspec, seq_ax, None, None),
        "shared_v": P(None, bspec, seq_ax, None, None),
        "wkv": P(None, bspec, "model" if ms > 1 and cfg.n_heads % ms == 0
                 else None, None, None),
        "shift1": P(None, bspec, None),
        "shift2": P(None, bspec, None),
    }
    sizes = mesh_sizes(mesh)
    out = {}
    for k, (shp, dtype) in _cache_shapes(cfg, b, s).items():
        fixed = []
        for dim, ax in zip(shp, rules[k]):
            if ax is None:
                fixed.append(None)
                continue
            size = 1
            for a in (ax if isinstance(ax, tuple) else (ax,)):
                size *= sizes.get(a, 1)
            fixed.append(ax if dim % size == 0 else None)
        out[k] = ShapeDtypeStruct(shp, dtype, P(*fixed))
    return out


def decode_token_specs(cfg: ArchConfig, shape: ShapeSpec, mesh):
    """One decode step's tokens, (B, 1) int32."""
    b = shape.global_batch
    return ShapeDtypeStruct((b, 1), torch.int32, P(_bspec(mesh, b), None))


def cell_is_runnable(cfg: ArchConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """The skip matrix: long_500k runs on the SSM and hybrid archs only."""
    if shape.name == "long_500k":
        if cfg.family in ("ssm", "hybrid"):
            return True, ""
        return False, ("skipped: pure full-attention arch — 500k decode "
                       "needs sub-quadratic mixing (DESIGN.md §5)")
    return True, ""
