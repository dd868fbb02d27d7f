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
``torch.autograd``.  The mini-batch path (bulk-sampled subgraphs) is not
ported.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Literal, Mapping, Optional, Tuple

import numpy as np
import torch

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
    them from a generator seeded with ``seed``.  Each step reads its loss
    back to the host.
    """
    if mesh is not None:
        raise NotImplementedError(
            "train_gnn(mesh=...) is multi-device, ROADMAP Queue A item 7")
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
        loss = _loss_fn(cfg, live, a, x, labels, mask)
        keys = sorted(live)
        grads = dict(zip(keys, torch.autograd.grad(
            loss, [live[k] for k in keys])))
        grads, _ = clip_by_global_norm(grads, 1.0)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = apply_updates(params, updates)
        history.append(float(loss.detach()))
    return params, history


def gnn_forward_minibatch(*args, **kwargs):
    """Not ported: the layer-wise forward over ``bulk_sample`` subgraphs."""
    raise NotImplementedError(
        "gnn_forward_minibatch needs apps/sampling.py: ROADMAP Queue A item 4")


def train_gnn_minibatch(*args, **kwargs):
    """Not ported: mini-batch training on ``bulk_sample`` subgraph chains."""
    raise NotImplementedError(
        "train_gnn_minibatch needs apps/sampling.py: ROADMAP Queue A item 4")
