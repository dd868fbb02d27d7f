"""GNN full-batch training with TopK structured pruning (paper §V-C, Eq. 1-3).

Counterpart of ``repro.apps.gnn``'s full-batch path.  Three architectures
(GCN, GIN, GraphSAGE, the paper's Fig. 10/11 set), each with a pruning
layer that sparsifies activations so that the aggregation
``A · TopK(X) · W`` gathers sparse rows.  The TopK backward is the paper's
Eq. (3) winner-take-all mask (``topk_rows_st``).

``sparse_mode``:
  * "topk"  — Eq. (1): aggregation over TopK-masked features (the paper's
              AIA-accelerated path: the row gather inside ``csr_spmm`` is
              the two-level indirection AIA serves);
  * "dense" — the cuSPARSE-role baseline: dense Â @ X @ W.

Every tensor lives on the adjacency's device; a training step is eager
``torch.autograd``.

Mini-batch path (``train_gnn_minibatch``): each step trains on a
bulk-sampled subgraph chain from ``apps.sampling.bulk_sample``, the
SpGEMM-expressed sampler whose per-batch probability patterns repeat every
epoch, so one shared ``PlanCache`` serves the sampler's plans from the
second epoch on; ``weight_sets`` routes the probability products through
the batched executor.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Literal, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.launch.sharding import shard_devices
from repro_torch.optim import adamw, apply_updates, clip_by_global_norm
from repro_torch.sparse.formats import CSR
from repro_torch.sparse.ops import csr_spmm
from repro_torch.sparse.topk import topk_rows_st


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    arch: Literal["gcn", "gin", "sage"] = "gcn"
    n_layers: int = 2
    d_in: int = 64
    d_hidden: int = 64
    n_classes: int = 7
    topk: int = 16  # k of Eq. (1); <= d_hidden
    sparse_mode: Literal["topk", "dense"] = "topk"
    # How the aggregation's row gather is served: "aia" by the AIA kernel
    # (the paper's accelerated path), "xla" by a plain take (software
    # only), "auto" by the kernel on a CUDA device.
    gather: Literal["auto", "xla", "aia"] = "auto"


def normalize_adjacency(a: CSR) -> CSR:
    """Â = D^{-1/2} (A+I) D^{-1/2} for GCN, on ``a``'s device."""
    from repro_torch.apps.markov_clustering import add_self_loops
    from repro_torch.sparse.ops import csr_scale_columns, csr_scale_rows

    a = add_self_loops(a)
    deg = a.row_nnz().to(torch.float32)
    dinv = 1.0 / torch.sqrt(torch.clamp(deg, min=1.0))
    return csr_scale_columns(csr_scale_rows(a, dinv), dinv)


def param_shapes(cfg: GNNConfig) -> Dict[str, Tuple[int, ...]]:
    """Every parameter's name (the reference's keys) and shape."""
    dims = [cfg.d_in] + [cfg.d_hidden] * (cfg.n_layers - 1) + [cfg.n_classes]
    shapes = {}
    for layer in range(cfg.n_layers):
        shapes[f"w{layer}"] = (dims[layer], dims[layer + 1])
        if cfg.arch == "sage":
            shapes[f"w_self{layer}"] = (dims[layer], dims[layer + 1])
        if cfg.arch == "gin":
            shapes[f"eps{layer}"] = ()
    return shapes


def init_gnn(cfg: GNNConfig, generator: torch.Generator,
             device="cuda") -> Dict[str, torch.Tensor]:
    """Weights ~ N(0, 1/fan_in) drawn from ``generator`` (on its device,
    then placed on ``device``); GIN's eps at 0."""
    params = {}
    for name, shape in param_shapes(cfg).items():
        if not shape:
            params[name] = torch.zeros((), dtype=torch.float32, device=device)
            continue
        w = torch.randn(shape, generator=generator, device=generator.device)
        params[name] = (w / np.sqrt(shape[0])).to(torch.float32).to(device)
    return params


def gnn_params_from_numpy(cfg: GNNConfig, params: Mapping[str, np.ndarray],
                          device="cuda") -> Dict[str, torch.Tensor]:
    """Parameters from host arrays keyed as the reference's ``init_gnn``
    keys them (e.g. the reference's parameters read out with numpy), bit
    for bit, as float32 on ``device``."""
    shapes = param_shapes(cfg)
    if set(params) != set(shapes):
        raise ValueError(f"expected the keys {sorted(shapes)}, got "
                         f"{sorted(params)}")
    out = {}
    for name, shape in shapes.items():
        arr = np.asarray(params[name], np.float32)
        if arr.shape != shape:
            raise ValueError(f"{name}: shape {arr.shape}, expected {shape}")
        out[name] = torch.from_numpy(arr.copy()).to(device)
    return out


def _aggregate(a: CSR, x: torch.Tensor, mode: str, k: int,
               gather: str = "auto", mesh=None) -> torch.Tensor:
    """A · TopK(X): Eq. (1)'s sparse aggregation (or the dense baseline)."""
    if mode == "topk":
        x = topk_rows_st(x, k)  # Eq. (2) forward, Eq. (3) backward
    return csr_spmm(a, x, gather=gather, mesh=mesh)


def gnn_forward(cfg: GNNConfig, params: Dict, a: CSR, x: torch.Tensor,
                mesh=None) -> torch.Tensor:
    """Forward pass; returns the logits (n, n_classes)."""
    h = x
    for layer in range(cfg.n_layers):
        k = min(cfg.topk, h.shape[1])
        mode = cfg.sparse_mode if layer > 0 else "dense"  # inputs stay dense
        agg = _aggregate(a, h, mode, k, gather=cfg.gather, mesh=mesh)
        if cfg.arch == "gcn":
            h = agg @ params[f"w{layer}"]
        elif cfg.arch == "gin":
            h = ((1.0 + params[f"eps{layer}"]) * h + agg) @ params[f"w{layer}"]
        else:  # sage: self + mean-ish neighbor path
            h = h @ params[f"w_self{layer}"] + agg @ params[f"w{layer}"]
        if layer < cfg.n_layers - 1:
            h = torch.relu(h)
    return h


def _loss_fn(cfg, params, a, x, labels, mask, mesh=None):
    logits = gnn_forward(cfg, params, a, x, mesh=mesh)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.take_along_dim(logp, labels[:, None], dim=1)[:, 0]
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def train_gnn(
    cfg: GNNConfig,
    a: CSR,
    x,
    labels,
    n_steps: int = 30,
    lr: float = 1e-2,
    seed: int = 0,
    mesh=None,
    params: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[Dict, List[float]]:
    """Full-batch training loop on ``a``'s device; returns (params, loss
    history).

    ``params`` are the starting parameters (e.g. the reference's, carried
    across with ``gnn_params_from_numpy``); by default ``init_gnn`` draws
    them from a generator seeded with ``seed``.  ``mesh`` row-shards every
    aggregation, forward and backward (``sparse.ops.csr_spmm``; ``a`` on
    the mesh's merge device).  Each step reads its loss back to the host.
    """
    shard_devices(mesh)  # a bad mesh fails before any work
    dev = a.device
    if params is None:
        params = init_gnn(cfg, torch.Generator().manual_seed(seed), dev)
    opt = adamw(lr, weight_decay=0.0)
    opt_state = opt.init(params)
    x = torch.as_tensor(x, device=dev)
    labels = torch.as_tensor(labels, device=dev).long()
    mask = torch.ones(labels.shape[0], dtype=torch.float32, device=dev)

    history = []
    for _ in range(n_steps):
        live = {k: p.detach().requires_grad_() for k, p in params.items()}
        loss = _loss_fn(cfg, live, a, x, labels, mask, mesh=mesh)
        keys = sorted(live)
        grads = dict(zip(keys, torch.autograd.grad(
            loss, [live[k] for k in keys])))
        grads, _ = clip_by_global_norm(grads, 1.0)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = apply_updates(params, updates)
        history.append(float(loss.detach()))
    return params, history


def gnn_forward_minibatch(cfg: GNNConfig, params: Dict,
                          adjs: Sequence[CSR], frontiers: Sequence,
                          x: torch.Tensor, mesh=None) -> torch.Tensor:
    """Layer-wise forward over one ``bulk_sample`` subgraph chain; returns
    the logits of ``frontiers[0]`` (the batch vertices).

    ``adjs[l]`` maps frontier l+1's features onto frontier l.  Features
    flow from the outermost frontier inwards: layer 0 (dense, as in the
    full-batch path) consumes the last adjacency.  GIN's and SAGE's self
    features are the previous frontier's rows at the positions of the
    current one (``Q^l ⊆ Q^{l+1}``, both sorted, so ``np.searchsorted``).
    ``mesh`` row-shards every aggregation (``sparse.ops.csr_spmm``).
    """
    shard_devices(mesh)  # a bad mesh fails before any work
    n_layers = cfg.n_layers
    if len(adjs) != n_layers:
        raise ValueError(f"{len(adjs)} adjacencies for {n_layers} layers")
    dev = x.device
    h = x[torch.as_tensor(np.asarray(frontiers[n_layers]), device=dev)]
    for layer in range(n_layers):
        t = n_layers - 1 - layer  # chain position this layer consumes
        rows = np.asarray(frontiers[t])
        cols = np.asarray(frontiers[t + 1])
        k = min(cfg.topk, h.shape[1])
        mode = cfg.sparse_mode if layer > 0 else "dense"
        agg = _aggregate(adjs[t], h, mode, k, gather=cfg.gather, mesh=mesh)
        h_self = h[torch.from_numpy(np.searchsorted(cols, rows)).to(dev)]
        if cfg.arch == "gcn":
            h = agg @ params[f"w{layer}"]
        elif cfg.arch == "gin":
            h = ((1.0 + params[f"eps{layer}"]) * h_self + agg) \
                @ params[f"w{layer}"]
        else:  # sage
            h = h_self @ params[f"w_self{layer}"] + agg @ params[f"w{layer}"]
        if layer < n_layers - 1:
            h = torch.relu(h)
    return h


def train_gnn_minibatch(
    cfg: GNNConfig,
    a: CSR,
    x,
    labels,
    batch_size: int = 32,
    n_epochs: int = 2,
    fanout: int = 4,
    lr: float = 1e-2,
    seed: int = 0,
    engine: str = "sort",
    mesh=None,
    weight_sets: Optional[np.ndarray] = None,
    reuse_plan: bool = True,
    pipeline: str = "two_wave",
    sizing: str = "auto",
    params: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[Dict, List[float], Dict[str, int]]:
    """Mini-batch training on ``bulk_sample`` subgraph chains, on ``a``'s
    device; returns (params, per-step loss history, amortisation stats).

    The batches are ``np.random.default_rng(seed).permutation(n)`` cut
    into ``batch_size`` slices (each sorted); batch ``bi`` is sampled with
    seed ``seed * 100_000 + bi`` in every epoch, so a revisited batch
    repeats its frontiers and its SpGEMM patterns, and with ``reuse_plan``
    one ``PlanCache(max_entries=256)`` serves them (``stats``:
    ``plan_cache_hits``, ``plan_cache_misses``).  ``params`` are the
    starting parameters (by default ``init_gnn`` from a generator seeded
    with ``seed``).  ``engine``, ``weight_sets``, ``pipeline`` and
    ``sizing`` go to every sampling SpGEMM; ``a`` should already be
    normalised as the architecture expects.  ``mesh`` runs the sampling
    SpGEMMs and the aggregations on its shards (``a`` on its merge
    device).  Each step reads its loss back to the host.
    """
    from repro_torch.apps.sampling import bulk_sample
    from repro_torch.core import executor
    from repro_torch.core.executor import PlanCache

    shard_devices(mesh)  # a bad mesh fails before any work
    engine = executor.resolve_engine(engine)
    dev = a.device
    if params is None:
        params = init_gnn(cfg, torch.Generator().manual_seed(seed), dev)
    opt = adamw(lr, weight_decay=0.0)
    opt_state = opt.init(params)
    x = torch.as_tensor(x, device=dev)
    labels_np = np.asarray(torch.as_tensor(labels).cpu())
    n = a.n_rows
    order = np.random.default_rng(seed).permutation(n)
    batches = [np.sort(order[i: i + batch_size])
               for i in range(0, n, batch_size)]
    plan_cache = PlanCache(max_entries=256) if reuse_plan else None

    history: List[float] = []
    for _ in range(n_epochs):
        for bi, batch in enumerate(batches):
            adjs, frontiers = bulk_sample(
                a, batch, fanout=fanout, n_layers=cfg.n_layers,
                seed=seed * 100_000 + bi,  # the same in every epoch
                engine=engine, gather=cfg.gather, mesh=mesh,
                plan_cache=plan_cache,
                weight_sets=weight_sets, pipeline=pipeline, sizing=sizing)
            y = torch.from_numpy(labels_np[frontiers[0]]).long().to(dev)
            live = {k: p.detach().requires_grad_() for k, p in params.items()}
            logits = gnn_forward_minibatch(cfg, live, adjs, frontiers, x,
                                           mesh=mesh)
            logp = torch.log_softmax(logits, dim=-1)
            loss = -torch.mean(torch.take_along_dim(logp, y[:, None], dim=1))
            keys = sorted(live)
            grads = dict(zip(keys, torch.autograd.grad(
                loss, [live[k] for k in keys])))
            grads, _ = clip_by_global_norm(grads, 1.0)
            updates, opt_state = opt.update(grads, opt_state, params)
            params = apply_updates(params, updates)
            history.append(float(loss.detach()))
    stats = {
        "plan_cache_hits": plan_cache.hits if plan_cache else 0,
        "plan_cache_misses": plan_cache.misses if plan_cache else 0,
    }
    return params, history, stats
