"""Shared model substrate: norms, RoPE, inits, chunked losses.

Counterpart of ``repro.models.common``, function for function.  Inits take
an explicit ``torch.Generator`` (its device is where the weights are made);
they draw from the reference's distributions, not its random numbers.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.distributed.tensor import DTensor, Replicate
from torch.utils.checkpoint import checkpoint

from repro_torch.launch.sharding import unsplit


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5
             ) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * w


def residual(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x + y``, the residual stream's add.  For DTensors ``y`` (a
    row-parallel product's partial sums) is first placed as ``x``, so the
    stream keeps its placement between the reference's constraints
    (DTensor would otherwise pick a cheaper reduce-scatter and split the
    stream's sequence dim)."""
    if isinstance(x, DTensor) and isinstance(y, DTensor) \
            and tuple(y.placements) != tuple(x.placements):
        y = y.redistribute(x.device_mesh, x.placements)
    return x + y


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype) * w + b


def dense_init(generator: torch.Generator, d_in: int, d_out: int,
               dtype: torch.dtype = torch.bfloat16,
               scale: Optional[float] = None,
               layers: Optional[int] = None) -> torch.Tensor:
    """N(0, 1) * scale (default ``1/sqrt(d_in)``) of shape ``(d_in, d_out)``,
    or ``(layers, d_in, d_out)`` for a stack of layers, drawn in float32 on
    the generator's device and rounded to ``dtype``."""
    s = scale if scale is not None else 1.0 / d_in ** 0.5
    shape = (d_in, d_out) if layers is None else (layers, d_in, d_out)
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    return (w * s).to(dtype)


def replicated_like(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``t`` as a DTensor replicated on ``x``'s mesh when ``x`` is a
    DTensor and ``t`` is not (a constant that meets ``x`` in an op whose
    backward reads it); ``t`` otherwise."""
    if isinstance(x, DTensor) and not isinstance(t, DTensor):
        return DTensor.from_local(t, x.device_mesh,
                                  [Replicate()] * x.device_mesh.ndim,
                                  run_check=False)
    return t


def rope_frequencies(head_dim: int, theta: float = 10000.0,
                     device="cuda") -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq).  The rotation
    pairs the two halves of the head dim (the reference's split-halves
    layout), not neighbouring lanes."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, device=x.device)  # (hd/2,)
    angles = positions[..., :, None].float() * freqs  # (..., seq, hd/2)
    cos = replicated_like(torch.cos(angles)[..., :, None, :], x)
    sin = replicated_like(torch.sin(angles)[..., :, None, :], x)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def cross_entropy_chunked(logits_fn: Callable, h: torch.Tensor,
                          labels: torch.Tensor, w_out: torch.Tensor,
                          n_chunks: int = 8) -> torch.Tensor:
    """Memory-safe LM loss: vocab logits one sequence chunk at a time.

    h: (B, S, D) final hidden; labels: (B, S) integer (-1 = masked);
    w_out: (D, V).  The (B, S, V) logits are never all materialised: under
    autograd each chunk runs under ``torch.utils.checkpoint``, so its
    float32 logits are freed after its forward and made again in its
    backward, one chunk at a time (autograd would otherwise keep every
    chunk's logits for ``logsumexp``'s backward).  The chunks' sums are
    added in order, as the reference's scan does.  DTensor logits split
    over the vocab are gathered a chunk at a time.
    """
    b, s, d = h.shape
    assert s % n_chunks == 0, (s, n_chunks)
    cs = s // n_chunks

    def chunk_loss(hh, ll, w):
        logits = logits_fn(hh, w).float()  # (B, cs, V)
        logits = unsplit(logits, 2)  # the gold logit needs a whole row
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1,
                            ll.clamp_min(0).long()[..., None])[..., 0]
        return torch.sum((logz - gold) * (ll >= 0).float())

    total = torch.zeros((), dtype=torch.float32, device=h.device)
    count = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(n_chunks):
        hh, ll = h[:, i * cs:(i + 1) * cs], labels[:, i * cs:(i + 1) * cs]
        if torch.is_grad_enabled() and (h.requires_grad
                                        or w_out.requires_grad):
            part = checkpoint(chunk_loss, hh, ll, w_out, use_reentrant=False)
        else:
            part = chunk_loss(hh, ll, w_out)
        total = total + part
        count = count + torch.sum((ll >= 0).float())
    return total / torch.clamp_min(count, 1.0)


def causal_mask(sq: int, sk: int, offset: int = 0,
                device="cuda") -> torch.Tensor:
    """(sq, sk) bool: query i attends key j iff j <= i + offset."""
    qi = torch.arange(sq, device=device)[:, None] + offset
    kj = torch.arange(sk, device=device)[None, :]
    return kj <= qi


def sliding_window_mask(sq: int, sk: int, window: int, offset: int = 0,
                        device="cuda") -> torch.Tensor:
    qi = torch.arange(sq, device=device)[:, None] + offset
    kj = torch.arange(sk, device=device)[None, :]
    return (kj <= qi) & (kj > qi - window)
