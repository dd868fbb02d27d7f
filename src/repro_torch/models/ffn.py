"""FFNs: dense SwiGLU, the paper's TopK-SpGEMM FFN (Eq. 1–3), and MoE.

Counterpart of ``repro.models.ffn`` (``moe_ffn_shard_map``, a collective,
waits for the multi-device pieces of ROADMAP Queue A item 12).
``ffn_mode``:

* "dense"      — published architecture;
* "topk"       — Eq. (1): h is TopK-masked (``sparse.topk.topk_rows_st``,
                 with the Eq. (3) backward), then multiplied by W2 densely;
* "block_topk" — per tile of tokens, keep the ``k/block`` blocks of
                 ``block`` d_ff lanes with the most energy
                 (``tile_block_select``), gather only the selected W2
                 row-blocks and contract.

All three are plain PyTorch, as the reference writes them in jnp; the
sparse products have their own kernels behind ``kernels.ops``
(``topk_spmm``, ``block_topk_spmm``).

MoE (``moe_ffn``): token-choice top-k with capacity and the reference's
sort-based dispatch, its grouped expert products as batched matmuls over
the stacked expert weights (the reference leaves them to XLA), and a
combine that adds each token's k contributions in the dispatch stream's
order (ascending expert id) without atomics, so a call gives the same bits
every run on the card.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init
from repro_torch.sparse.topk import topk_rows, topk_rows_st


class FFNParams(NamedTuple):
    w1: torch.Tensor  # gate (D, F)
    w3: torch.Tensor  # up   (D, F)
    w2: torch.Tensor  # down (F, D)


def ffn_init(generator, d_model, d_ff, dtype,
             layers: Optional[int] = None) -> FFNParams:
    """Weights for one layer, or stacked for ``layers`` layers."""
    return FFNParams(
        w1=dense_init(generator, d_model, d_ff, dtype, layers=layers),
        w3=dense_init(generator, d_model, d_ff, dtype, layers=layers),
        w2=dense_init(generator, d_ff, d_model, dtype, layers=layers),
    )


def _hidden(p: FFNParams, x):
    return F.silu(x @ p.w1) * (x @ p.w3)


def swiglu(p: FFNParams, x):
    return _hidden(p, x) @ p.w2


def topk_ffn(p: FFNParams, x, k: int):
    """Eq. (1): y = TopK(act(xW1)⊙(xW3)) @ W2 with Eq. (3) backward."""
    h = _hidden(p, x)
    b, s, f = h.shape
    hs = topk_rows_st(h.reshape(b * s, f), k).reshape(b, s, f)
    return hs @ p.w2


def tile_block_select(h: torch.Tensor, kb: int, block: int, tile: int):
    """``block_topk_ffn``'s selection on ``h`` (n, f): per tile of ``tile``
    tokens, the ``kb`` blocks of ``block`` lanes with the most float32
    energy (lower block first among equals, as ``lax.top_k``).  Returns
    h_kept (n_tiles, kb, tile, block) and bidx (n_tiles, kb) int32."""
    n, f = h.shape
    nb, nt = f // block, n // tile
    hb = h.reshape(nt, tile, nb, block)
    bidx = topk_rows(hb.float().square().sum((1, 3)), kb).indices
    tiles = torch.arange(nt, device=h.device)[:, None]
    h_kept = hb.permute(0, 2, 1, 3)[tiles, bidx.long()].contiguous()
    return h_kept, bidx.contiguous()


def block_topk_ffn(p: FFNParams, x, k: int, block: int = 128,
                   tile: int = 8):
    """Tile-shared block TopK + W2 block gather: the second product's
    operations drop from S·F·D to S·k·D."""
    h = _hidden(p, x)
    b, s, f = h.shape
    assert s % tile == 0, (s, tile)
    h_kept, bidx = tile_block_select(h.reshape(b * s, f), max(k // block, 1),
                                     block, tile)
    w2b = p.w2.reshape(f // block, block, p.w2.shape[1])
    w2_sel = w2b[bidx.long()]  # (nt, kb, block, D): the AIA ranged gather
    y = torch.einsum("nktb,nkbd->ntd", h_kept, w2_sel)
    return y.reshape(b, s, p.w2.shape[1])


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

class MoEParams(NamedTuple):
    router: torch.Tensor        # (D, E) float32
    w1: torch.Tensor            # (E, D, Fe)
    w3: torch.Tensor            # (E, D, Fe)
    w2: torch.Tensor            # (E, Fe, D)
    shared: Optional[FFNParams]  # the fused shared experts (or None)


def _moe_layer(generator, d_model, cfg, dtype) -> MoEParams:
    e, fe = cfg.n_experts, cfg.d_ff_expert
    s1, s2 = 1.0 / math.sqrt(d_model), 1.0 / math.sqrt(fe)

    def normal(shape, scale):
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
        return (w * scale).to(dtype)

    router = dense_init(generator, d_model, e, torch.float32)
    w1 = normal((e, d_model, fe), s1)
    w3 = normal((e, d_model, fe), s1)
    w2 = normal((e, fe, d_model), s2)
    shared = (ffn_init(generator, d_model, cfg.n_shared * fe, dtype)
              if cfg.n_shared else None)
    return MoEParams(router, w1, w3, w2, shared)


def moe_init(generator, d_model, cfg, dtype, layers: Optional[int] = None,
             device=None) -> MoEParams:
    """One layer's router (float32), experts and shared experts, drawn as
    the reference draws them (not its numbers); or ``layers`` of them
    stacked on ``device`` (default: the generator's), drawn and placed one
    layer at a time: the float32 draw of a whole stack's ``w1`` at
    DeepSeek-V2-Lite's width would take 19 GB."""
    if layers is None:
        return _moe_layer(generator, d_model, cfg, dtype)
    device = device if device is not None else generator.device
    stacks = None
    for i in range(layers):
        one = _moe_layer(generator, d_model, cfg, dtype)
        leaves = [one.router, one.w1, one.w3, one.w2] + \
            (list(one.shared) if one.shared is not None else [])
        if stacks is None:
            stacks = [torch.empty((layers, *t.shape), dtype=t.dtype,
                                  device=device) for t in leaves]
        for st, t in zip(stacks, leaves):
            st[i].copy_(t)
    return MoEParams(*stacks[:4], FFNParams(*stacks[4:]) if stacks[4:]
                     else None)


def moe_capacity(tokens: int, cfg) -> int:
    """Slots per expert: ``max(8, min(ceil(T·k/E·capacity_factor), T))``."""
    cap = int(math.ceil(tokens * cfg.top_k / cfg.n_experts
                        * cfg.capacity_factor))
    return max(8, min(cap, tokens))


def moe_route(p: MoEParams, xt: torch.Tensor, cfg):
    """The router on tokens ``xt`` (T, D): float32 logits (T, E), each
    token's top-k experts (T, k) by logit, largest first, and their gates,
    a softmax over the k logits."""
    logits = xt.float() @ p.router
    gate_logits, expert_idx = torch.topk(logits, cfg.top_k, dim=-1)
    return logits, expert_idx, torch.softmax(gate_logits, dim=-1)


def moe_ffn(p: MoEParams, x, cfg):
    """Token-choice top-k with capacity; sort-based dispatch (static
    shapes).  x (B, S, D) -> (y (B, S, D), the Switch-style aux loss).

    The (token, slot) pairs are stably sorted by expert; a pair past its
    expert's ``cap`` slots goes to the overflow row and contributes 0.
    Token t's output is its k gate-weighted expert outputs added in the
    sorted stream's order (ascending expert id), k adds in the output
    dtype, then the shared experts' SwiGLU.
    """
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    e, k = cfg.n_experts, cfg.top_k
    cap = moe_capacity(t, cfg)
    logits, expert_idx, gates = moe_route(p, xt, cfg)

    # ---- sort-based dispatch: group the (token, slot) pairs by expert ----
    flat_e = expert_idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    e_sorted = flat_e[order]
    t_sorted = order // k  # the token of each pair
    g_sorted = gates.reshape(-1)[order]
    counts = torch.bincount(e_sorted, minlength=e)
    starts = torch.cumsum(counts, 0) - counts
    stream = torch.arange(t * k, device=x.device)
    pos_in_e = stream - starts[e_sorted]
    slot = torch.where(pos_in_e < cap, e_sorted * cap + pos_in_e, e * cap)

    # the expert-major (E*cap, D) buffer; the overflow row is dropped
    buf = x.new_zeros((e * cap + 1, d))
    buf[slot] = xt[t_sorted]
    buf = buf[:-1].reshape(e, cap, d)

    # the grouped expert products over the stacked weights
    h = F.silu(torch.bmm(buf, p.w1)) * torch.bmm(buf, p.w3)
    y = torch.bmm(h, p.w2).reshape(e * cap, d)

    # combine: each kept pair's expert output, weighted by its gate
    y_slot = torch.cat([y, y.new_zeros((1, d))])[slot]
    contrib = y_slot * g_sorted[:, None].to(y.dtype)
    at = torch.empty_like(order)
    at[order] = stream  # the stream position of each (token, slot) pair
    at = at.reshape(t, k).sort(dim=1).values
    out = contrib[at[:, 0]]
    for j in range(1, k):
        out = out + contrib[at[:, j]]
    out = out.reshape(b, s, d)
    if p.shared is not None:
        out = out + swiglu(p.shared, x)

    # load-balance auxiliary loss (Switch style)
    me = torch.softmax(logits, dim=-1).mean(dim=0)
    ce = counts.float() / torch.clamp_min(counts.sum(), 1)
    aux = e * torch.sum(me * ce)
    return out, aux
