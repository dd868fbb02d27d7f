"""RWKV-6 "Finch" block: data-dependent decay WKV and channel mix
[arXiv:2404.05892].

Counterpart of ``repro.models.rwkv6``, function for function.  Per head:
``S_t = diag(w_t)·S_{t-1} + k_tᵀ v_t``, ``o_t = r_t·(S_{t-1} +
diag(u)·k_tᵀ v_t)``, with ``w_t = exp(−exp(w0 + LoRA(x_t)))`` data
dependent per channel.  Token shift mixes with the static learned μ.

Prefill takes the chunked WKV (``_wkv_chunked``: the quadratic form inside
a chunk in log space, the state carried across chunks by a Python loop in
place of the reference's ``lax.scan``); decode the per-token recurrence
(``_wkv_chunk``).  The reference leaves both to XLA and runs no Pallas
kernel for them; here they are ``torch.einsum``, so the block runs no kernel
of this repository.  The dtype steps are the reference's: r, k and v in
float32, the decay LoRA in float32, ``w0`` and ``u`` float32 parameters,
the WKV output cast to the activation dtype before its norm.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init, rms_norm


class RWKV6Params(NamedTuple):
    mu_r: torch.Tensor  # (D,) token-shift mixes
    mu_k: torch.Tensor
    mu_v: torch.Tensor
    mu_w: torch.Tensor
    wr: torch.Tensor    # (D, D)
    wk: torch.Tensor
    wv: torch.Tensor
    wg: torch.Tensor
    w0: torch.Tensor    # (D,) decay base, float32
    w_lora_a: torch.Tensor  # (D, 64)
    w_lora_b: torch.Tensor  # (64, D)
    u: torch.Tensor     # (H, P) bonus, float32
    ln_w: torch.Tensor  # (D,) norm scale on the output
    wo: torch.Tensor    # (D, D)
    # channel mix
    mu_ck: torch.Tensor
    mu_cr: torch.Tensor
    ck: torch.Tensor    # (D, F)
    cv: torch.Tensor    # (F, D)
    cr: torch.Tensor    # (D, D)


def rwkv6_init(generator, d_model, d_ff, n_heads, dtype,
               layers: Optional[int] = None) -> RWKV6Params:
    """One layer's parameters, or a stack of ``layers``, drawn on the
    generator's device from the reference's distributions: projections
    N(0, 1/d_in), the mixes 0.5, ``w0`` -2, ``u`` 0, the norm 1."""
    p = d_model // n_heads
    lead = () if layers is None else (layers,)
    dev = generator.device

    def mk(a, b):
        return dense_init(generator, a, b, dtype, layers=layers)

    def full(shape, value, dt=dtype):
        return torch.full(lead + shape, value, dtype=dt, device=dev)

    return RWKV6Params(
        mu_r=full((d_model,), 0.5), mu_k=full((d_model,), 0.5),
        mu_v=full((d_model,), 0.5), mu_w=full((d_model,), 0.5),
        wr=mk(d_model, d_model), wk=mk(d_model, d_model),
        wv=mk(d_model, d_model), wg=mk(d_model, d_model),
        w0=full((d_model,), -2.0, torch.float32),
        w_lora_a=mk(d_model, 64), w_lora_b=mk(64, d_model),
        u=full((n_heads, p), 0.0, torch.float32),
        ln_w=full((d_model,), 1.0),
        wo=mk(d_model, d_model),
        mu_ck=full((d_model,), 0.5), mu_cr=full((d_model,), 0.5),
        ck=mk(d_model, d_ff), cv=mk(d_ff, d_model), cr=mk(d_model, d_model),
    )


def _token_shift(x, mu, x_prev=None):
    """lerp(x_{t-1}, x_t, mu); ``x_prev`` (B, D) is the carry for decode."""
    if x_prev is None:
        prev = F.pad(x[:, :-1], (0, 0, 1, 0))
    else:
        prev = torch.cat([x_prev[:, None, :], x[:, :-1]], dim=1)
    return prev + mu * (x - prev)


def _wkv_chunk(r, k, v, w, u, s0):
    """The per-token recurrence over one span.

    r, k, v: (B, Q, H, P); w: (B, Q, H, P) decay in (0, 1); s0: (B, H, P, P).
    Returns (out (B, Q, H, P), s_final)."""
    s = s0
    outs = []
    for t in range(r.shape[1]):
        rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], w[:, t]  # (B, H, P)
        kv = torch.einsum("bhp,bhq->bhpq", kt, vt)  # key-major outer
        outs.append(torch.einsum("bhp,bhpq->bhq", rt,
                                 s + u[None, :, :, None] * kv))
        s = wt[..., None] * s + kv
    return torch.stack(outs, dim=1), s


def _wkv_chunked(r, k, v, w, u, s0, chunk: int):
    """The chunked parallel WKV: inside a chunk of Q steps the quadratic
    form ``M[j, t, p] = r_j[p]·k_t[p]·exp(cl_{j-1}[p] − cl_t[p])`` (t < j)
    in log space, where every exponent is <= 0; the state carried across
    chunks."""
    b, s, h, p_dim = r.shape
    q = min(chunk, s)
    assert s % q == 0, (s, q)
    nc = s // q

    def chunks(x):
        return x.reshape(b, nc, q, h, p_dim)

    rc, kc, vc, wc = map(chunks, (r, k, v, w))
    logw = torch.log(torch.clamp_min(wc, 1e-38))
    cl = torch.cumsum(logw, dim=2)  # inclusive (B, nc, Q, H, P)
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=r.device),
                      diagonal=-1)
    s_prev = s0
    outs = []
    for c in range(nc):
        rj, kj, vj, clj = rc[:, c], kc[:, c], vc[:, c], cl[:, c]
        # cl_{j-1}: the exclusive cumsum (cl_0 = 0)
        cl_excl = F.pad(clj[:, :-1], (0, 0, 0, 0, 1, 0))
        # intra-chunk quadratic form, strictly lower triangular in (j, t)
        diff = cl_excl[:, :, None] - clj[:, None, :]  # (B, Qj, Qt, H, P)
        m = torch.exp(torch.where(mask[None, :, :, None, None], diff,
                                  float("-inf")))
        m = m * rj[:, :, None] * kj[:, None, :]
        intra = torch.einsum("bjthp,bthq->bjhq", m, vj)
        bonus = torch.einsum("bjhp,hp,bjhp->bjh", rj, u, kj)
        intra = intra + bonus[..., None] * vj
        # inter-chunk: the state from the chunks before
        inter = torch.einsum("bjhp,bhpq->bjhq", rj * torch.exp(cl_excl),
                             s_prev)
        # the state at the end of the chunk
        tail = torch.exp(clj[:, -1:, :] - clj)  # decay from t to chunk end
        s_prev = s_prev * torch.exp(clj[:, -1])[..., None] + \
            torch.einsum("bthp,bthq->bhpq", kj * tail, vj)
        outs.append(intra + inter)
    out = torch.stack(outs, dim=1).reshape(b, s, h, p_dim)
    return out, s_prev


def rwkv6_time_mix(p: RWKV6Params, x, *, n_heads, state=None, x_prev=None,
                   chunk: int = 0):
    """x: (B, S, D).  ``state`` (B, H, P, P): the carried WKV state
    (decode).  ``chunk > 0`` takes the chunked WKV (prefill), ``chunk ==
    0`` the per-token recurrence (decode).  Returns (out, final state, the
    last token's x); the inputs are not written."""
    b, s, d = x.shape
    hp = d // n_heads
    xr = _token_shift(x, p.mu_r, x_prev)
    xk = _token_shift(x, p.mu_k, x_prev)
    xv = _token_shift(x, p.mu_v, x_prev)
    xw = _token_shift(x, p.mu_w, x_prev)
    r = (xr @ p.wr).reshape(b, s, n_heads, hp).float()
    k = (xk @ p.wk).reshape(b, s, n_heads, hp).float()
    v = (xv @ p.wv).reshape(b, s, n_heads, hp).float()
    g = F.silu(xr @ p.wg)
    # Finch's data-dependent decay
    wlog = p.w0 + (torch.tanh(xw.float() @ p.w_lora_a.float())
                   @ p.w_lora_b.float())
    w = torch.exp(-torch.exp(wlog)).reshape(b, s, n_heads, hp)  # (0, 1)
    s0 = state if state is not None else torch.zeros(
        (b, n_heads, hp, hp), dtype=torch.float32, device=x.device)
    if chunk and s > 1:
        out, s_final = _wkv_chunked(r, k, v, w, p.u, s0, chunk)
    else:
        out, s_final = _wkv_chunk(r, k, v, w, p.u, s0)
    out = out.reshape(b, s, d).to(x.dtype)
    out = rms_norm(out, p.ln_w) * g
    return out @ p.wo, s_final, x[:, -1, :]


def rwkv6_channel_mix(p: RWKV6Params, x, x_prev=None):
    """The channel mix: (out, the last token's x)."""
    xk = _token_shift(x, p.mu_ck, x_prev)
    xr = _token_shift(x, p.mu_cr, x_prev)
    k = torch.square(torch.relu(xk @ p.ck))
    return torch.sigmoid(xr @ p.cr) * (k @ p.cv), x[:, -1, :]
