"""Multi-pod dry run: trace every (architecture x input shape) cell on both
production meshes, on the meta device, in one process.

Counterpart of ``repro.launch.dryrun``.  The reference lowers and compiles
each cell with XLA on 512 forced host devices and reads XLA's memory and
cost analyses.  The port traces the same step instead: the mesh is a
``DeviceMesh`` over torch's fake process group of 256 (single-pod,
``(16, 16)``) or 512 (multi-pod, ``(2, 16, 16)``) ranks, the state and the
batch are meta DTensors placed by ``launch.specs``, and one call of the
step runs on them under ``kernels.ops.shape_trace`` (each kernel's plain
version on meta; train cells the full ``make_train_step``: loss,
gradients, AdamW; prefill cells the forward and the last position's
logits; decode cells ``decode_step`` against a ``seq_len`` cache).
Nothing is allocated and no collective moves data.  The record counts,
for rank 0:

* ``flops_per_device``: the FLOPs of the rank's local operations by
  ``FlopCounterMode``'s formulas (each DTensor operation's local work, not
  its global view);
* ``bytes_accessed_per_device``: the bytes of every local operation's
  tensor inputs and outputs (views and factories excluded);
* ``collective_bytes``: the output bytes of each collective, by kind, and
  ``collective_counts`` from ``CommDebugMode``;
* ``memory``: the rank's shards of the arguments (state and batch) and of
  the outputs.  ``temp_bytes`` is not measured on the meta device (None),
  and nothing is donated (``alias_bytes`` 0).

A failure here (a placement that does not propagate, an operation DTensor
has no rule for) is a bug in the port.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-3-2b \\
        --shape train_4k [--multi-pod] [--single-only] [--json out.json]

Without ``--arch`` or ``--shape`` every arch or every shape runs.  The
module sets no environment variable: the fake process group is made, and
destroyed, around each mesh (``fake_mesh``), so it needs no other
process group in the same process.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import re
import time
from typing import Dict

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import ARCH_IDS, SHAPE_SETS, get_config
from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.kernels import ops
from repro_torch.launch import specs as sp
from repro_torch.launch.mesh import (compat_make_mesh, mesh_sizes,
                                     production_mesh_shape, use_mesh)
from repro_torch.launch.sharding import (NamedSharding, distribute,
                                         make_shardings, tree_map)
from repro_torch.models import transformer as tf
from repro_torch.optim import adamw
from repro_torch.train.step import make_train_step

_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather", "all_gather": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "all_reduce": "all-reduce", "allreduce_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
}


COLLECTIVE_RE = re.compile(
    r"(all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute)"
    r"[^=]*=\s*\(?([a-z0-9]+)\[([0-9,]*)\]")


def collective_bytes_from_hlo(hlo: str) -> Dict[str, float]:
    """The reference's count on XLA's post-SPMD HLO text: the output-shape
    bytes of every collective op, by kind.  The port's trace has no HLO (it
    counts the collectives it runs, ``_Costs``); this reads HLO text that
    the reference wrote."""
    dtype_bytes = {"f32": 4, "bf16": 2, "f16": 2, "s32": 4, "u32": 4,
                   "s8": 1, "u8": 1, "pred": 1, "f64": 8, "s64": 8, "c64": 8}
    out: Dict[str, float] = {}
    for m in COLLECTIVE_RE.finditer(hlo):
        kind, dt, dims = m.group(1), m.group(2), m.group(3)
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        out[kind] = out.get(kind, 0.0) + n * dtype_bytes.get(dt, 4)
    return out


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _is_dtensor_op(types) -> bool:
    return any(isinstance(t, type) and issubclass(t, DTensor) for t in types)


class _Costs(TorchDispatchMode):
    """Each rank's local work: the FLOPs of every local operation by
    ``FlopCounterMode``'s formulas (``flop_registry``), the bytes that the
    local operations read and write (tensor inputs and outputs; views and
    factories move nothing), and each collective's output bytes by kind.
    An operation on DTensors is handed back (``NotImplemented``, as
    ``CommDebugMode`` does), so DTensor runs it and the mode sees the local
    operations it turns into, not the global one it stands for."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes_accessed = 0
        self.collective_bytes: Dict[str, float] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(isinstance(t, type) and issubclass(t, DTensor)
               for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = _tensors((args, kwargs))
        if any(isinstance(t, FakeTensor) for t in ins):
            return out  # DTensor's shape propagation, on global shapes
        packet = func.overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        kind = _COLLECTIVES.get(packet.__name__)
        if kind is not None:
            b = sum(_nbytes(t) for t in _tensors(out))
            self.collective_bytes[kind] = \
                self.collective_bytes.get(kind, 0.0) + b
        elif ins and not func.is_view:  # factories allocate, move nothing
            self.bytes_accessed += sum(_nbytes(t) for t in ins) + sum(
                _nbytes(t) for t in _tensors(out))
        return out


@contextlib.contextmanager
def fake_mesh(shape, axes):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over torch's fake
    process group (rank 0 of ``prod(shape)``), destroyed on exit.  The
    process must have no other default process group."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry run makes its own fake process group; "
                           "this process already has one")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape))
    try:
        yield compat_make_mesh(shape, axes, device_type="cpu")
    finally:
        dist.destroy_process_group()


def _meta(tree, mesh):
    """Meta DTensors, placed on ``mesh``, for a tree of
    ``launch.specs.ShapeDtypeStruct``s."""
    return tree_map(lambda s: distribute(s.meta(), NamedSharding(mesh, s.spec)),
                    tree)


def _local_bytes(tree) -> int:
    return sum(_nbytes(t.to_local() if isinstance(t, DTensor) else t)
               for t in _tensors(tree))


def shape_for(cfg: ArchConfig, shape: ShapeSpec) -> ShapeSpec:
    return shape


def lower_cell(cfg: ArchConfig, shape: ShapeSpec, mesh, verbose=True):
    """Trace one cell on ``mesh`` (a ``DeviceMesh`` over a fake process
    group, ``fake_mesh``); returns the analysis record."""
    sh = make_shardings(mesh)
    t0 = time.monotonic()
    costs = _Costs()
    from torch.distributed.tensor.debug import CommDebugMode
    comm = CommDebugMode()
    with use_mesh(mesh):
        if shape.kind == "train":
            args = (_meta(sp.train_state_sds(cfg, mesh), mesh),
                    _meta(sp.batch_specs(cfg, shape, mesh), mesh))
            step = make_train_step(cfg, adamw(3e-4), sh=sh)
        elif shape.kind == "prefill":
            def step(params, batch):
                h, _ = tf.forward_hidden(
                    cfg, params, batch["tokens"], sh,
                    vision_embeds=batch.get("vision_embeds"),
                    frames=batch.get("frames"))
                return sh.act_btv(h[:, -1:, :] @ params["lm_head"])
            batch = sp.batch_specs(cfg, shape, mesh)
            batch.pop("labels")
            args = (_meta(sp.param_sds(cfg, mesh)[0], mesh),
                    _meta(batch, mesh))
        else:  # decode
            def step(params, cache, tokens):
                return tf.decode_step(cfg, params, cache, tokens, sh)
            args = (_meta(sp.param_sds(cfg, mesh)[0], mesh),
                    _meta(sp.cache_specs(cfg, shape, mesh), mesh),
                    _meta(sp.decode_token_specs(cfg, shape, mesh), mesh))
        with comm, costs, ops.shape_trace():
            out = step(*args)
    t_trace = time.monotonic() - t0
    rec = {
        "arch": cfg.name,
        "shape": shape.name,
        "mesh": mesh_sizes(mesh),
        "trace_s": round(t_trace, 2),
        "flops_per_device": float(costs.flops),
        "bytes_accessed_per_device": float(costs.bytes_accessed),
        "collective_bytes": costs.collective_bytes,
        "collective_counts": {str(k): v for k, v in
                              comm.get_comm_counts().items()},
        "memory": {
            "argument_bytes": _local_bytes(args),
            "output_bytes": _local_bytes(out),
            "temp_bytes": None,
            "alias_bytes": 0,
        },
        # the trace allocates on no device: CUDA is never initialised
        "cuda_initialized": torch.cuda.is_initialized(),
    }
    if verbose:
        print(f"[dryrun] {cfg.name} × {shape.name} × mesh"
              f"{tuple(rec['mesh'].values())} trace={t_trace:.1f}s")
        print(f"  memory: args={rec['memory']['argument_bytes'] / 2**30:.2f}"
              f"GiB out={rec['memory']['output_bytes'] / 2**30:.2f}GiB "
              f"(per device)")
        print(f"  cost: flops/dev={rec['flops_per_device']:.3e}"
              f" bytes/dev={rec['bytes_accessed_per_device']:.3e}")
        print(f"  collectives: "
              f"{ {k: f'{v:.3e}' for k, v in rec['collective_bytes'].items()} }")
    return rec


# ---------------------------------------------------------------------------
# Measurement mode: the reference extrapolates per-layer costs from 1- and
# 2-unit graphs because XLA counts a loop body once.  The port's trace runs
# every layer, so ``lower_cell`` is exact at full depth; ``measure_cell``
# keeps the reference's extrapolation for a cheaper trace.
# ---------------------------------------------------------------------------

def _unit_plan(cfg: ArchConfig):
    """Returns (cfg_at_1_unit, cfg_at_2_units, units_true)."""
    meas = dict(unroll_layers=True, unroll_inner=True, attn_chunk=4096,
                remat_groups=0, rwkv_chunk=64)
    if cfg.encoder_layers:  # whisper: one unit = 1 enc + 1 dec layer
        c1 = dataclasses.replace(cfg, n_layers=1, encoder_layers=1, **meas)
        c2 = dataclasses.replace(cfg, n_layers=2, encoder_layers=2, **meas)
        return c1, c2, float(cfg.n_layers)
    if cfg.block_pattern == "M" and cfg.shared_attn_every:  # zamba2 segment
        u = cfg.shared_attn_every
        c1 = dataclasses.replace(cfg, n_layers=u, **meas)
        c2 = dataclasses.replace(cfg, n_layers=2 * u, **meas)
        return c1, c2, cfg.n_layers / u
    if cfg.first_layer_dense_ffn:  # the prefix stays in the fixed part
        c1 = dataclasses.replace(cfg, n_layers=2, **meas)
        c2 = dataclasses.replace(cfg, n_layers=3, **meas)
        return c1, c2, float(cfg.n_layers - 1)
    c1 = dataclasses.replace(cfg, n_layers=1, **meas)
    c2 = dataclasses.replace(cfg, n_layers=2, **meas)
    return c1, c2, float(cfg.n_layers)


def measure_cell(cfg: ArchConfig, shape: ShapeSpec, mesh, verbose=True):
    """Per-step flops / bytes / collective bytes for one cell, extrapolated
    from 1 and 2 depth units: C(1) + (C(2) - C(1)) * (U - 1)."""
    c1, c2, units = _unit_plan(cfg)
    r1 = lower_cell(c1, shape, mesh, verbose=False)
    r2 = lower_cell(c2, shape, mesh, verbose=False)

    def extrap(k1, k2):
        return k1 + (k2 - k1) * (units - 1.0)

    coll = {}
    for kind in set(r1["collective_bytes"]) | set(r2["collective_bytes"]):
        coll[kind] = max(extrap(r1["collective_bytes"].get(kind, 0.0),
                                r2["collective_bytes"].get(kind, 0.0)), 0.0)
    rec = {
        "arch": cfg.name,
        "shape": shape.name,
        "mesh": mesh_sizes(mesh),
        "measured": True,
        "units_true": units,
        "flops_per_device": extrap(r1["flops_per_device"],
                                   r2["flops_per_device"]),
        "bytes_accessed_per_device": extrap(r1["bytes_accessed_per_device"],
                                            r2["bytes_accessed_per_device"]),
        "collective_bytes": coll,
        "memory": r2["memory"],
        "unit_records": [r1, r2],
    }
    if verbose:
        print(f"[measure] {cfg.name} × {shape.name}: "
              f"flops/dev={rec['flops_per_device']:.3e} "
              f"bytes/dev={rec['bytes_accessed_per_device']:.3e} "
              f"coll={ {k: f'{v:.2e}' for k, v in coll.items()} }")
    return rec


def run(arch_ids, shape_names, multi_pod: bool, out_json=None,
        also_single=True):
    records = []
    meshes = []
    if also_single:
        meshes.append(production_mesh_shape(multi_pod=False))
    if multi_pod:
        meshes.append(production_mesh_shape(multi_pod=True))
    for arch in arch_ids:
        cfg = get_config(arch)
        for shape in SHAPE_SETS:
            if shape_names and shape.name not in shape_names:
                continue
            ok, why = sp.cell_is_runnable(cfg, shape)
            if not ok:
                print(f"[dryrun] {arch} × {shape.name}: {why}")
                records.append({"arch": arch, "shape": shape.name,
                                "skipped": why})
                continue
            for mesh_shape, axes in meshes:
                with fake_mesh(mesh_shape, axes) as mesh:
                    records.append(lower_cell(cfg, shape, mesh))
    if out_json:
        with open(out_json, "w") as f:
            json.dump(records, f, indent=1)
        print(f"[dryrun] wrote {len(records)} records to {out_json}")
    return records


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="arch id (default: all)")
    ap.add_argument("--shape", default=None, help="shape name (default: all)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="also run the 2×16×16 multi-pod mesh")
    ap.add_argument("--single-only", action="store_true")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    archs = [args.arch] if args.arch else list(ARCH_IDS)
    shapes = [args.shape] if args.shape else None
    return run(archs, shapes, multi_pod=args.multi_pod and not args.single_only,
               out_json=args.json)


if __name__ == "__main__":
    main()
