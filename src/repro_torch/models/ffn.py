"""FFNs: dense SwiGLU, the paper's TopK-SpGEMM FFN (Eq. 1–3), and MoE.

Counterpart of ``repro.models.ffn``.  ``ffn_mode``:

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
every run on the card.  Its row gathers (the tokens into the dispatch
buffer, the gates, the expert outputs back to their pairs, the combine's
parts) go through ``sparse.ops.take_rows`` (``take_rows_padded`` where a
dropped pair reads the zero row), whose backward adds the cotangent rows
of a repeated row (a token's k pairs) in the stream's order, each add
rounded to the rows' type, as the reference's gathers transpose
(``.at[].add``), through the segment-sum kernel on the card.
``moe_ffn_shard_map`` is its expert-parallel form under a mesh: each
``model`` rank runs its own experts on its batch shard's tokens, and one
all-reduce over ``model`` combines them.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Replicate
from torch.distributed.tensor.experimental import local_map

from repro_torch.models.common import dense_init
from repro_torch.sparse.ops import take_rows, take_rows_padded
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


def _act_btf(h, sh):
    return h if sh is None else sh.act_btf(h)


def swiglu(p: FFNParams, x, sh=None):
    """SwiGLU; ``sh`` constrains the hidden activation to d_ff on
    ``model``."""
    return _act_btf(_hidden(p, x), sh) @ p.w2


def topk_ffn(p: FFNParams, x, k: int, sh=None):
    """Eq. (1): y = TopK(act(xW1)⊙(xW3)) @ W2 with Eq. (3) backward."""
    h = _act_btf(_hidden(p, x), sh)
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
                   tile: int = 8, sh=None):
    """Tile-shared block TopK + W2 block gather: the second product's
    operations drop from S·F·D to S·k·D."""
    h = _act_btf(_hidden(p, x), sh)
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


def _combine(contrib, order, t: int, k: int, stream, model_group=None):
    """Each token's k gate-weighted contributions (rows of ``contrib`` in
    stream order) added in the stream's order.  With ``model_group`` the
    (T, k, D) stack is summed over the group first: each (token, pick) is
    one rank's and 0 on the others, so the sum is exact and the adds keep
    the unsharded order."""
    at = torch.empty_like(order)
    at[order] = stream  # the stream position of each (token, slot) pair
    parts = take_rows(contrib, at.reshape(t, k).sort(dim=1).values
                      .reshape(-1)).reshape(t, k, -1)
    if model_group is not None:
        from torch.distributed.nn.functional import all_reduce
        parts = all_reduce(parts, group=model_group)
    out = parts[:, 0]
    for j in range(1, k):
        out = out + parts[:, j]
    return out


def _aux_loss(logits, counts, e: int):
    """Switch-style load balance: E * sum(mean softmax * dispatch share)."""
    me = torch.softmax(logits, dim=-1).mean(dim=0)
    ce = counts.float() / torch.clamp_min(counts.sum(), 1)
    return e * torch.sum(me * ce)


def moe_ffn_shard_map(p: MoEParams, x, cfg, sh):
    """Expert-parallel MoE with explicit collectives (the reference's
    ``shard_map`` form): x (B, S, D) a DTensor split over the batch dims
    and replicated over ``model``, the experts split over ``model``.

    Each ``model`` rank routes its batch shard's tokens (capacity from the
    shard's token count) to its own ``E / |model|`` experts only: no
    dispatch traffic, since x is replicated over ``model``.  It runs them
    with ``moe_ffn``'s batched products, and one all-reduce over ``model``
    of the (T_local, k, D) contributions combines them in ``moe_ffn``'s
    stream order (the reference reduces (T_local, D) partial sums, which
    reorders the k adds; the port keeps them bit for bit ``moe_ffn``'s when
    no token drops).  aux is each shard's estimate, averaged over the batch
    dims.  Then the shared experts' SwiGLU, as in ``moe_ffn``.  Returns
    (y, aux), DTensors.
    """
    from repro_torch.launch.mesh import mesh_sizes
    from repro_torch.launch.sharding import P, placements

    mesh = sh.mesh
    sizes = mesh_sizes(mesh)
    model_size = sizes.get("model", 1)
    e, k = cfg.n_experts, cfg.top_k
    if e % model_size:
        raise ValueError(f"{e} experts do not split over model={model_size}")
    e_loc = e // model_size
    _, s, d = x.shape
    xpl = placements(sh.spec("b", "-", "-"), mesh, 3)
    espl = placements(P("model" if model_size > 1 else None, None, None),
                      mesh, 3)
    rpl = placements(P(None, None), mesh, 2)
    scalar = tuple(Replicate() for _ in xpl)
    model_group = mesh.get_group("model") if model_size > 1 else None
    batch_groups = [mesh.get_group(a) for a in sh.batch_axes
                    if sizes[a] > 1]

    def local(router, w1, w3, w2, xl):
        from torch.distributed.nn.functional import all_reduce

        j = mesh.get_local_rank("model") if model_size > 1 else 0
        bl = xl.shape[0]
        t = bl * s
        xt = xl.reshape(t, d)
        cap = moe_capacity(t, cfg)
        logits, expert_idx, gates = moe_route(
            MoEParams(router, w1, w3, w2, None), xt, cfg)
        flat_e = expert_idx.reshape(-1)
        order = torch.argsort(flat_e, stable=True)
        e_sorted = flat_e[order]
        g_sorted = take_rows(gates.reshape(-1, 1), order)[:, 0]
        counts = torch.bincount(e_sorted, minlength=e)
        starts = torch.cumsum(counts, 0) - counts
        stream = torch.arange(t * k, device=xl.device)
        pos_in_e = stream - starts[e_sorted]
        e_local = e_sorted - j * e_loc
        mine = (e_local >= 0) & (e_local < e_loc) & (pos_in_e < cap)
        slot = torch.where(mine, e_local * cap + pos_in_e, e_loc * cap)
        buf = xl.new_zeros((e_loc * cap + 1, d))
        buf[slot] = take_rows(xt, order // k)
        buf = buf[:-1].reshape(e_loc, cap, d)
        h = F.silu(torch.bmm(buf, w1)) * torch.bmm(buf, w3)
        y = torch.bmm(h, w2).reshape(e_loc * cap, d)
        y_slot = take_rows_padded(y, slot)
        contrib = y_slot * g_sorted[:, None].to(y.dtype)
        out = _combine(contrib, order, t, k, stream, model_group)
        aux = _aux_loss(logits, counts, e)
        for g in batch_groups:
            aux = all_reduce(aux, group=g)
        n_batch = 1
        for a in sh.batch_axes:
            n_batch *= sizes[a]
        return out.reshape(bl, s, d), aux / n_batch

    out, aux = local_map(
        local, out_placements=(xpl, scalar),
        in_placements=(rpl, espl, espl, espl, xpl), device_mesh=mesh,
        redistribute_inputs=True)(p.router, p.w1, p.w3, p.w2, x)
    if p.shared is not None:
        out = out + swiglu(p.shared, x, sh=sh)
    return out, aux


def moe_ffn(p: MoEParams, x, cfg, sh=None):
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
    g_sorted = take_rows(gates.reshape(-1, 1), order)[:, 0]
    counts = torch.bincount(e_sorted, minlength=e)
    starts = torch.cumsum(counts, 0) - counts
    stream = torch.arange(t * k, device=x.device)
    pos_in_e = stream - starts[e_sorted]
    slot = torch.where(pos_in_e < cap, e_sorted * cap + pos_in_e, e * cap)

    # the expert-major (E*cap, D) buffer; the overflow row is dropped
    buf = x.new_zeros((e * cap + 1, d))
    buf[slot] = take_rows(xt, t_sorted)  # backward: .at[t_sorted].add
    buf = buf[:-1].reshape(e, cap, d)
    if sh is not None:
        buf = sh.act_ecd(buf)  # experts on the model dim

    # the grouped expert products over the stacked weights
    h = F.silu(torch.bmm(buf, p.w1)) * torch.bmm(buf, p.w3)
    y = torch.bmm(h, p.w2)
    if sh is not None:
        y = sh.act_ecd(y)
    y = y.reshape(e * cap, d)

    # combine: each kept pair's expert output, weighted by its gate
    y_slot = take_rows_padded(y, slot)
    contrib = y_slot * g_sorted[:, None].to(y.dtype)
    out = _combine(contrib, order, t, k, stream).reshape(b, s, d)
    if p.shared is not None:
        out = out + swiglu(p.shared, x, sh=sh)
    return out, _aux_loss(logits, counts, e)
