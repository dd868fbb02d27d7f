"""Mamba2 (SSD) block: the chunked dual form for prefill, an O(1) state
update for decode [arXiv:2405.21060].

Counterpart of ``repro.models.mamba2``, function for function.  State
update ``h_t = exp(a_h·dt_t)·h_{t-1} + dt_t·B_t x_t^T``, ``y_t = C_t·h_t``.
The chunked algorithm computes the intra-chunk terms as (Q×Q) products and
carries the (H, P, N) state across chunks.  The reference leaves the
einsums to XLA and carries the state with ``lax.scan``; here they are
``torch.einsum`` and a Python loop over the chunks, so the SSD runs no
kernel of this repository (the reference runs no Pallas kernel for it
either).  Parameters are the reference's ``Mamba2Params``, one layer's
tensors or a stack with a leading layer axis.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init, rms_norm


class Mamba2Params(NamedTuple):
    in_proj: torch.Tensor   # (D, 2*di + 2*N + H)  -> z, x, B, C, dt
    conv_w: torch.Tensor    # (conv, di + 2*N) depthwise causal conv
    a_log: torch.Tensor     # (H,) float32
    d_skip: torch.Tensor    # (H,) float32
    dt_bias: torch.Tensor   # (H,) float32
    norm_w: torch.Tensor    # (di,) gated RMSNorm
    out_proj: torch.Tensor  # (di, D)


def mamba2_dims(d_model, expand, head_dim, state):
    """(inner width di, heads)."""
    di = expand * d_model
    return di, di // head_dim


def mamba2_init(generator, d_model, *, expand, head_dim, state, conv, dtype,
                layers: Optional[int] = None) -> Mamba2Params:
    """One layer's parameters, or a stack of ``layers``, drawn on the
    generator's device from the reference's distributions: projections
    N(0, 1/d_in), the conv taps N(0, 1/conv), ``a_log`` and ``dt_bias`` 0,
    ``d_skip`` and the norm 1."""
    di, heads = mamba2_dims(d_model, expand, head_dim, state)
    lead = () if layers is None else (layers,)
    dev = generator.device

    def full(n, value, dt):
        return torch.full(lead + (n,), value, dtype=dt, device=dev)

    conv_w = torch.randn(lead + (conv, di + 2 * state), generator=generator,
                         dtype=torch.float32, device=dev) / conv ** 0.5
    return Mamba2Params(
        in_proj=dense_init(generator, d_model, 2 * di + 2 * state + heads,
                           dtype, layers=layers),
        conv_w=conv_w.to(dtype),
        a_log=full(heads, 0.0, torch.float32),
        d_skip=full(heads, 1.0, torch.float32),
        dt_bias=full(heads, 0.0, torch.float32),
        norm_w=full(di, 1.0, dtype),
        out_proj=dense_init(generator, di, d_model, dtype, layers=layers),
    )


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, ``log(1 + exp(x))`` as ``logaddexp(x, 0)``
    (``torch.nn.functional.softplus`` returns x itself past 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _causal_conv(x, w, state=None):
    """Depthwise causal conv along seq.  x: (B, S, C); w: (K, C).

    With ``state`` (B, K-1, C) the conv continues from a previous chunk and
    the new state is returned (decode).  The K taps are added in the
    reference's order, a Python ``sum`` from 0."""
    k = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    out = sum(xp[:, i:i + x.shape[1], :] * w[i][None, None, :]
              for i in range(k))
    new_state = xp[:, -(k - 1):, :] if k > 1 else torch.zeros_like(pad)
    return out, new_state


def _split_proj(p, x, di, state, heads):
    zxbcdt = x @ p.in_proj
    z = zxbcdt[..., :di]
    rest = zxbcdt[..., di:]
    xbc = rest[..., :di + 2 * state]
    dt = rest[..., di + 2 * state:]
    return z, xbc, dt


def mamba2_forward(p: Mamba2Params, x, *, expand, head_dim, state, conv,
                   chunk: int = 64):
    """Train/prefill SSD.  x: (B, S, D) -> (B, S, D); S a multiple of
    ``min(chunk, S)``, as in the reference."""
    b, s, d = x.shape
    di, heads = mamba2_dims(d, expand, head_dim, state)
    pdim = head_dim
    z, xbc, dt = _split_proj(p, x, di, state, heads)
    xbc, _ = _causal_conv(xbc, p.conv_w)
    xbc = F.silu(xbc)
    xin = xbc[..., :di].reshape(b, s, heads, pdim)
    bmat = xbc[..., di:di + state]          # (B, S, N)
    cmat = xbc[..., di + state:]            # (B, S, N)
    dt = softplus(dt.float() + p.dt_bias)   # (B, S, H)
    a = -torch.exp(p.a_log)                 # (H,)
    la = a[None, None, :] * dt              # log decay (B, S, H)

    q = min(chunk, s)
    assert s % q == 0, (s, q)
    nc = s // q
    xin = xin.reshape(b, nc, q, heads, pdim).float()
    bmat = bmat.reshape(b, nc, q, state).float()
    cmat = cmat.reshape(b, nc, q, state).float()
    dt = dt.reshape(b, nc, q, heads)
    la = la.reshape(b, nc, q, heads)
    cum = torch.cumsum(la, dim=2)  # (B, nc, Q, H) inclusive log-decay

    # intra-chunk (dual quadratic form): L[b,c,i,j,h] = exp(cum_i - cum_j)
    # for j <= i
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    ldiff = torch.where(mask[None, None, :, :, None],
                        cum[:, :, :, None, :] - cum[:, :, None, :, :],
                        float("-inf"))
    decay = torch.exp(ldiff)  # (B, nc, Q, Q, H)
    del ldiff
    scores = torch.einsum("bcin,bcjn->bcij", cmat, bmat)  # (B, nc, Q, Q)
    m = scores[..., None] * decay * dt[:, :, None, :, :]  # j-indexed dt
    del decay
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", m, xin)
    del m

    # chunk states, then the inter-chunk carry
    tail = torch.exp(cum[:, :, -1:, :] - cum)  # decay from j to chunk end
    chunk_state = torch.einsum("bcjn,bcjh,bcjhp->bchpn", bmat, dt * tail,
                               xin)  # (B, nc, H, P, N)
    chunk_decay = torch.exp(cum[:, :, -1, :])  # (B, nc, H)
    h = torch.zeros((b, heads, pdim, state), dtype=torch.float32,
                    device=x.device)
    h_prev = []
    for c in range(nc):  # the state *before* each chunk
        h_prev.append(h)
        h = h * chunk_decay[:, c, :, None, None] + chunk_state[:, c]
    h_prev = torch.stack(h_prev, dim=1)  # (B, nc, H, P, N)
    y_inter = torch.einsum("bcin,bchpn,bcih->bcihp", cmat, h_prev,
                           torch.exp(cum))
    y = (y_intra + y_inter).reshape(b, s, heads, pdim)
    y = y + p.d_skip[None, None, :, None] * xin.reshape(b, s, heads, pdim)
    y = y.reshape(b, s, di).to(x.dtype)
    y = rms_norm(y * F.silu(z), p.norm_w)
    return y @ p.out_proj


def mamba2_decode(p: Mamba2Params, x, ssm_state, conv_state, *, expand,
                  head_dim, state, conv):
    """One token: the O(1) state update.  x: (B, 1, D); ssm_state (B, H, P,
    N) float32; conv_state (B, K-1, di + 2N).  Returns (output, new ssm
    state, new conv state); the inputs are not written."""
    b, _, d = x.shape
    di, heads = mamba2_dims(d, expand, head_dim, state)
    pdim = head_dim
    z, xbc, dt = _split_proj(p, x, di, state, heads)
    xbc, conv_state = _causal_conv(xbc, p.conv_w, conv_state)
    xbc = F.silu(xbc)
    xin = xbc[..., :di].reshape(b, heads, pdim)
    bmat = xbc[:, 0, di:di + state].float()   # (B, N)
    cmat = xbc[:, 0, di + state:].float()
    dt = softplus(dt[:, 0].float() + p.dt_bias)  # (B, H)
    a = -torch.exp(p.a_log)
    decay = torch.exp(a[None, :] * dt)  # (B, H)
    upd = torch.einsum("bh,bn,bhp->bhpn", dt, bmat, xin.float())
    ssm_state = ssm_state * decay[..., None, None] + upd
    y = torch.einsum("bn,bhpn->bhp", cmat, ssm_state)
    y = y + p.d_skip[None, :, None] * xin.float()
    y = y.reshape(b, 1, di).to(x.dtype)
    y = rms_norm(y * F.silu(z), p.norm_w)
    return y @ p.out_proj, ssm_state, conv_state
