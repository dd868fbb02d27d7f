"""Attention: GQA and MLA, train/prefill and decode paths.

Counterpart of ``repro.models.attention``.  Layouts are the reference's:
activations ``(B, S, H, D)``, KV caches ``(B, S_max, KV, D)``; MLA's decode
cache holds the latent ``(B, S_max, kv_lora)`` and the shared rope key
``(B, S_max, rope)``.

``flash_attention`` is the reference's online softmax over query and key
chunks.  A call inside the fused kernel's contract goes through
``kernels.ops.flash_attention_masked`` (K7: the CUDA kernel on the card, its
plain blockwise version on the CPU): Dv <= D <= 192, no ``p_dtype``, and
every query with at least one valid key; any window, query offset,
``kv_valid_len``, Sq and Sk.  So the causal self-attention of every model
here, MLA's expanded prefill (qk 192 = 128 + 64 rope lanes, v 128), Zamba2's
windowed shared block, Whisper's unmasked encoder over 1,500 frames and its
cross-attention (448 queries against 1,500 keys) take K7.  Every other call
runs the chunked PyTorch code (``flash_attention_chunked``, the reference's
arithmetic) on the CPU; on the card it raises, since the port has no kernel
for it.

The K7 route scales scores by ``1/sqrt(D)`` rounded once from double, as
the Pallas kernel does; the chunked code by ``1/sqrt(float32(D))``, as the
reference's model code does (one float32 ulp apart for D = 96).

``decode_attention`` and MLA's absorbed decode (``mla_decode``, float32
einsums) are plain PyTorch, as the reference leaves them to XLA.

Under a mesh q, k and v are DTensors, their heads on ``model`` after
``sh.act_bthd`` (``launch.sharding``): ``flash_attention`` then runs each
rank's heads and batch rows through ``local_map``, so K7 gets plain
tensors and its backward flows through autograd; a decode step writes the
token into a cache whose sequence dim is split into the shard that holds
its position (``write_at``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.kernels import ops
from repro_torch.launch.sharding import unsplit
from repro_torch.kernels.flash_attention import (MAX_HEAD_DIM,
                                                 rows_without_keys)
from repro_torch.models.common import apply_rope, dense_init, rms_norm

NEG_INF = -1e30


def _mask_val(qpos, kpos, causal: bool, window: int):
    ok = kpos <= qpos if causal else torch.ones_like(kpos <= qpos)
    if window:
        ok = ok & (kpos > qpos - window)
    return ok


def on_k7_route(sq: int, sk: int, d: int, dv: int, window: int = 0,
                q_offset: int = 0, kv_valid_len=None, p_dtype=None,
                causal: bool = True) -> bool:
    """True when ``flash_attention`` with these arguments goes through the
    fused kernel (K7): Dv <= D <= 192, no ``p_dtype``, and no query without
    a valid key."""
    return (dv <= d <= MAX_HEAD_DIM and p_dtype is None
            and not rows_without_keys(sq, sk, causal, window, q_offset,
                                      kv_valid_len))


def _fused(q, k, v, causal: bool, window: int, q_offset: int, kv_len):
    """K7 on the ``(B*H, S, D)`` layout: heads next to the batch, KV
    expanded to the query heads (head h reads kv head h // G); q keeps its
    length and v its width."""
    b, sq, h, _ = q.shape
    g = h // k.shape[2]
    if g > 1:
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)

    def heads_first(t):
        return t.permute(0, 2, 1, 3).reshape(b * h, t.shape[1], t.shape[3]) \
            .contiguous()

    out = ops.flash_attention_masked(heads_first(q), heads_first(k),
                                     heads_first(v), causal=causal,
                                     window=window, q_offset=q_offset,
                                     kv_len=kv_len)
    return out.reshape(b, h, sq, v.shape[3]).permute(0, 2, 1, 3)


def _local_heads(fn, q, k, v):
    """``fn(q, k, v)`` on each rank's shards of (B, S, H, D) DTensors
    (``local_map``): attention is independent across batch rows and heads,
    so q's placements may split dims 0 and 2 only; k and v are
    redistributed to them, and the output takes them."""
    pl = tuple(q.placements)
    for p in pl:
        if p.is_partial() or (isinstance(p, Shard) and p.dim not in (0, 2)):
            raise ValueError(f"attention on a DTensor placed {pl}: only the "
                             f"batch (0) and head (2) dims may be split")
    return local_map(fn, out_placements=list(pl), in_placements=(pl, pl, pl),
                     device_mesh=q.device_mesh,
                     redistribute_inputs=True)(q, k, v)


def split_heads(t: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    """(..., n*hd) -> (..., n, hd).  A DTensor split over the last dim by a
    mesh dim whose size does not divide ``n`` is gathered there first
    (GSPMD reshards such a view itself; DTensor refuses it)."""
    t = unsplit(t, t.dim() - 1, n)
    return t.reshape(*t.shape[:-1], n, hd)


def repeat_heads(t: torch.Tensor, g: int) -> torch.Tensor:
    """(B, S, KV, D) -> (B, S, KV*g, D), kv head j repeated g times in place
    (``repeat_interleave`` on dim 2, as ``jnp.repeat``), written as an
    expand and a reshape, so a DTensor split over its kv heads keeps the
    split over the query heads."""
    if g == 1:
        return t
    b, s, kv, d = t.shape
    return t[:, :, :, None].expand(b, s, kv, g, d).reshape(b, s, kv * g, d)


def flash_attention(
    q: torch.Tensor,            # (B, Sq, H, D)
    k: torch.Tensor,            # (B, Sk, KV, D)
    v: torch.Tensor,            # (B, Sk, KV, Dv)
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
    q_chunk: int = 512,
    k_chunk: int = 1024,
    kv_valid_len=None,
    p_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Online-softmax attention; O(S·chunk) memory.  GQA via head groups.

    ``p_dtype=torch.bfloat16`` rounds the softmax probabilities to bf16
    between the two products (the sums stay float32).  Returns ``(B, Sq, H,
    Dv)`` in ``q``'s dtype.
    """
    if isinstance(q, DTensor):
        return _local_heads(
            lambda ql, kl, vl: flash_attention(
                ql, kl, vl, causal, window, q_offset, q_chunk, k_chunk,
                kv_valid_len, p_dtype), q, k, v)
    b, sq, h, d = q.shape
    sk, dv = k.shape[1], v.shape[3]
    if on_k7_route(sq, sk, d, dv, window, q_offset, kv_valid_len, p_dtype,
                   causal):
        return _fused(q, k, v, causal, window, q_offset, kv_valid_len)
    if q.device.type != "cpu":
        empty = rows_without_keys(sq, sk, causal, window, q_offset,
                                  kv_valid_len)
        raise NotImplementedError(
            f"flash_attention(p_dtype={p_dtype}, D={d}, Dv={dv}, a query "
            f"without keys: {empty}) is outside the fused kernel's contract "
            f"(Dv <= D <= {MAX_HEAD_DIM}, no p_dtype, every query with a "
            f"valid key) and the port has no kernel for it on {q.device} "
            f"(ROADMAP Queue C)")
    return flash_attention_chunked(q, k, v, causal, window, q_offset,
                                   q_chunk, k_chunk, kv_valid_len, p_dtype)


def flash_attention_chunked(q, k, v, causal: bool = True, window: int = 0,
                            q_offset: int = 0, q_chunk: int = 512,
                            k_chunk: int = 1024, kv_valid_len=None,
                            p_dtype: Optional[torch.dtype] = None):
    """The reference's chunked online softmax, in plain PyTorch: query
    chunks, and inside each the key chunks in ascending order (ragged
    lengths padded to the chunk grid, padded keys masked).  The CPU runs it
    for the calls outside K7's contract."""
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    dv = v.shape[3]
    g = h // kv
    scale = float(1.0 / torch.sqrt(torch.tensor(d, dtype=torch.float32)))
    q_chunk = min(q_chunk, sq)
    k_chunk = min(k_chunk, sk)
    # pad ragged lengths up to the chunk grid; padded keys are masked via
    # kv_valid_len, padded queries are sliced off the output
    sq_orig, sk_orig = sq, sk
    if sq % q_chunk or sk % k_chunk:
        sq_pad, sk_pad = (-sq) % q_chunk, (-sk) % k_chunk
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, sq_pad))
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, sk_pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, sk_pad))
        sq, sk = sq + sq_pad, sk + sk_pad
        if kv_valid_len is None:
            kv_valid_len = sk_orig
        else:
            kv_valid_len = torch.clamp(torch.as_tensor(kv_valid_len),
                                       max=sk_orig)
    nq, nk = sq // q_chunk, sk // k_chunk

    qr = q.reshape(b, nq, q_chunk, kv, g, d)
    kr = k.reshape(b, nk, k_chunk, kv, d)
    vr = v.reshape(b, nk, k_chunk, kv, dv)
    outs = []
    for qi in range(nq):
        qc = qr[:, qi].float()  # (B, q_chunk, KV, G, D)
        m = torch.full((b, q_chunk, kv, g), NEG_INF, dtype=torch.float32)
        l = torch.zeros((b, q_chunk, kv, g), dtype=torch.float32)
        acc = torch.zeros((b, q_chunk, kv, g, dv), dtype=torch.float32)
        qpos = q_offset + qi * q_chunk + torch.arange(q_chunk)
        for kj in range(nk):
            s = torch.einsum("bqkgd,bckd->bqkgc", qc,
                             kr[:, kj].float()) * scale
            kpos = kj * k_chunk + torch.arange(k_chunk)
            ok = _mask_val(qpos[:, None], kpos[None, :], causal, window)
            if kv_valid_len is not None:
                ok = ok & (kpos[None, :] < kv_valid_len)
            s = torch.where(ok[None, :, None, None, :], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            vs = vr[:, kj]
            if p_dtype is not None:
                # rounded to p_dtype, multiplied and summed in float32
                p = p.to(p_dtype).float()
                vs = vs.to(p_dtype)
            acc = acc * corr[..., None] + torch.einsum(
                "bqkgc,bckd->bqkgd", p, vs.float())
            m = m_new
        outs.append((acc / l[..., None].clamp_min(1e-30)).to(q.dtype))
    out = torch.stack(outs, dim=1).reshape(b, sq, h, dv)
    return out[:, :sq_orig]


def decode_attention(
    q: torch.Tensor,        # (B, 1, H, D)
    k_cache: torch.Tensor,  # (B, S_max, KV, D)
    v_cache: torch.Tensor,
    cache_len,              # () current length INCLUDING the new token
    window: int = 0,
) -> torch.Tensor:
    """Single-token attention over the cache (plain PyTorch).  A DTensor
    cache whose sequence dim is split takes ``_split_decode``."""
    if isinstance(k_cache, DTensor):
        return _split_decode(q, k_cache, v_cache, cache_len, window)
    b, smax, kv, d = k_cache.shape
    h = q.shape[2]
    g = h // kv
    scale = float(1.0 / torch.sqrt(torch.tensor(d, dtype=torch.float32)))
    qr = unsplit(q, 2, kv).reshape(b, kv, g, d).float()
    s = torch.einsum("bkgd,bskd->bkgs", qr, k_cache.float()) * scale
    kpos = torch.arange(smax, device=q.device)
    ok = kpos < cache_len
    if window:
        ok = ok & (kpos >= cache_len - window)
    s = torch.where(ok[None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    return out.reshape(b, 1, h, d).to(q.dtype)


def _split_decode(q, k_cache, v_cache, cache_len, window: int = 0):
    """``decode_attention`` on DTensor caches (flash-decoding): each rank
    scores the new token against its own slice of the sequence, and the
    softmax's row max, its sum and the weighted values are all-reduced over
    the mesh dims that split the sequence.  q is replicated over all but
    the cache's batch split; the output is placed as q."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    mesh, cpl = k_cache.device_mesh, tuple(k_cache.placements)
    qpl = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                for p in cpl)
    groups = [mesh.get_group(i) for i, p in enumerate(cpl)
              if isinstance(p, Shard) and p.dim == 1]
    if isinstance(cache_len, DTensor):
        cache_len = cache_len.full_tensor()
    _, offset = compute_local_shape_and_global_offset(k_cache.shape, mesh,
                                                      cpl)

    def local(ql, kl, vl):
        b, sl, kv, d = kl.shape
        h = ql.shape[2]
        g = h // kv
        scale = float(1.0 / torch.sqrt(torch.tensor(d, dtype=torch.float32)))
        s = torch.einsum("bkgd,bskd->bkgs", ql.reshape(b, kv, g, d).float(),
                         kl.float()) * scale
        kpos = offset[1] + torch.arange(sl, device=ql.device)
        ok = kpos < cache_len
        if window:
            ok = ok & (kpos >= cache_len - window)
        s = torch.where(ok[None, None, None, :], s, NEG_INF)
        m = s.amax(-1, keepdim=True)
        for grp in groups:
            dist.all_reduce(m, op=dist.ReduceOp.MAX, group=grp)
        p = torch.exp(s - m)
        den = p.sum(-1, keepdim=True)
        acc = torch.einsum("bkgs,bskd->bkgd", p, vl.float())
        for grp in groups:
            dist.all_reduce(den, group=grp)
            dist.all_reduce(acc, group=grp)
        return (acc / den).reshape(b, 1, h, d).to(ql.dtype)

    return local_map(local, out_placements=list(qpl),
                     in_placements=(qpl, cpl, cpl), device_mesh=mesh,
                     redistribute_inputs=True)(q, k_cache, v_cache)


def write_at(cache: torch.Tensor, pos, val: torch.Tensor) -> None:
    """``cache[:, pos] = val`` in place: ``val`` is (B, 1, ...), ``pos`` a
    0-d integer tensor.  For a DTensor cache whose dim 1 (the sequence) is
    split, the rank holding position ``pos`` writes it and the others
    write back what they hold (no host read of ``pos``)."""
    if not isinstance(cache, DTensor):
        cache.index_copy_(1, pos.reshape(1).long(), val.to(cache.dtype))
        return
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    mesh, cpl = cache.device_mesh, tuple(cache.placements)
    vpl = tuple(Replicate() if isinstance(p, Shard) and p.dim == 1 else p
                for p in cpl)
    lv = val.redistribute(mesh, vpl).to_local().to(cache.dtype)
    if isinstance(pos, DTensor):
        pos = pos.full_tensor()
    shape, offset = compute_local_shape_and_global_offset(cache.shape, mesh,
                                                          cpl)
    lc = cache.to_local()
    i = pos.reshape(1).long() - offset[1]
    owned = ((i >= 0) & (i < shape[1])).reshape([1] * lv.dim())
    i = i.clamp(0, shape[1] - 1)
    lc.index_copy_(1, i, torch.where(owned, lv, lc.index_select(1, i)))


# ---------------------------------------------------------------------------
# GQA block-level wrappers
# ---------------------------------------------------------------------------

class AttnParams(NamedTuple):
    wq: torch.Tensor  # (D, H*hd)
    wk: torch.Tensor  # (D, KV*hd)
    wv: torch.Tensor  # (D, KV*hd)
    wo: torch.Tensor  # (H*hd, D)


def gqa_init(generator, d_model, n_heads, n_kv, hd, dtype,
             layers: Optional[int] = None) -> AttnParams:
    """Projections for one layer, or stacked for ``layers`` layers."""
    return AttnParams(
        wq=dense_init(generator, d_model, n_heads * hd, dtype, layers=layers),
        wk=dense_init(generator, d_model, n_kv * hd, dtype, layers=layers),
        wv=dense_init(generator, d_model, n_kv * hd, dtype, layers=layers),
        wo=dense_init(generator, n_heads * hd, d_model, dtype, layers=layers),
    )


def gqa_forward(p: AttnParams, x, *, n_heads, n_kv, hd, rope_theta,
                causal=True, window=0, positions=None, sh=None, cross_kv=None,
                attn_chunk=0, p_dtype=None):
    """Train/prefill attention.  cross_kv=(k,v) switches to cross-attention.
    ``sh`` constrains q, k and v to heads on ``model``."""
    b, s, d = x.shape
    q = split_heads(x @ p.wq, n_heads, hd)
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    g = n_heads // n_kv
    kw = dict(q_chunk=attn_chunk, k_chunk=attn_chunk) if attn_chunk else {}
    if cross_kv is None:
        k = split_heads(x @ p.wk, n_kv, hd)
        v = split_heads(x @ p.wv, n_kv, hd)
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
        # expand KV to the full head count, so the head dim splits evenly
        k, v = repeat_heads(k, g), repeat_heads(v, g)
        if sh is not None:
            q, k, v = sh.act_bthd(q), sh.act_bthd(k), sh.act_bthd(v)
        out = flash_attention(q, k, v, causal=causal, window=window,
                              p_dtype=p_dtype, **kw)
    else:
        k, v = cross_kv
        k, v = repeat_heads(k, g), repeat_heads(v, g)
        if sh is not None:
            q = sh.act_bthd(q)
            k, v = sh.act_bthd(k), sh.act_bthd(v)
        out = flash_attention(q, k, v, causal=False, p_dtype=p_dtype, **kw)
    return out.reshape(b, s, n_heads * hd) @ p.wo


def gqa_cross_kv(p: AttnParams, enc: torch.Tensor, n_kv, hd):
    """Encoder K/V computed once per sequence."""
    b, s, _ = enc.shape
    k = split_heads(enc @ p.wk, n_kv, hd)
    v = split_heads(enc @ p.wv, n_kv, hd)
    return k, v


def gqa_decode(p: AttnParams, x, k_cache, v_cache, pos, *, n_heads, n_kv,
               hd, rope_theta, window=0):
    """One decode step: write the token's K/V into the caches at ``pos`` (in
    place: the port does not copy the caches, where the reference returns
    new ones), attend over positions ``<= pos``.  pos: () integer tensor or
    int.  Returns (output, k_cache, v_cache)."""
    b = x.shape[0]
    q = split_heads(x @ p.wq, n_heads, hd)
    k = split_heads(x @ p.wk, n_kv, hd)
    v = split_heads(x @ p.wv, n_kv, hd)
    pos = torch.as_tensor(pos, device=x.device)
    posb = pos.reshape(1, 1).expand(b, 1)
    q = apply_rope(q, posb, rope_theta)
    k = apply_rope(k, posb, rope_theta)
    write_at(k_cache, pos, k)
    write_at(v_cache, pos, v)
    out = decode_attention(q, k_cache, v_cache, pos + 1, window=window)
    return out.reshape(b, 1, n_heads * hd) @ p.wo, k_cache, v_cache


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention, DeepSeek-V2)
# ---------------------------------------------------------------------------

class MLAParams(NamedTuple):
    wq: torch.Tensor       # (D, H*(nope+rope))
    w_dkv: torch.Tensor    # (D, kv_lora)
    w_kr: torch.Tensor     # (D, rope_dim) shared rope key
    w_uk: torch.Tensor     # (kv_lora, H*nope)
    w_uv: torch.Tensor     # (kv_lora, H*v_dim)
    wo: torch.Tensor       # (H*v_dim, D)
    norm_kv: torch.Tensor  # (kv_lora,)


def mla_init(generator, d_model, n_heads, mla, dtype,
             layers: Optional[int] = None) -> MLAParams:
    """Projections for one layer, or stacked for ``layers`` layers."""
    qd = n_heads * (mla.qk_nope_dim + mla.qk_rope_dim)
    norm = (mla.kv_lora,) if layers is None else (layers, mla.kv_lora)
    return MLAParams(
        wq=dense_init(generator, d_model, qd, dtype, layers=layers),
        w_dkv=dense_init(generator, d_model, mla.kv_lora, dtype,
                         layers=layers),
        w_kr=dense_init(generator, d_model, mla.qk_rope_dim, dtype,
                        layers=layers),
        w_uk=dense_init(generator, mla.kv_lora, n_heads * mla.qk_nope_dim,
                        dtype, layers=layers),
        w_uv=dense_init(generator, mla.kv_lora, n_heads * mla.v_head_dim,
                        dtype, layers=layers),
        wo=dense_init(generator, n_heads * mla.v_head_dim, d_model, dtype,
                      layers=layers),
        norm_kv=torch.ones(norm, dtype=dtype, device=generator.device),
    )


def mla_forward(p: MLAParams, x, *, n_heads, mla, rope_theta, sh=None,
                attn_chunk=0, p_dtype=None):
    """Train/prefill MLA (expanded form): q and k of ``nope + rope`` lanes,
    the rope key shared by every head, v of ``v_head_dim``; one
    ``flash_attention`` call, and so K7 on a full causal sequence."""
    b, s, _ = x.shape
    nd, rd, vd = mla.qk_nope_dim, mla.qk_rope_dim, mla.v_head_dim
    q = split_heads(x @ p.wq, n_heads, nd + rd)
    q_nope, q_rope = q[..., :nd], q[..., nd:]
    pos = torch.arange(s, device=x.device)[None, :]
    q_rope = apply_rope(q_rope, pos, rope_theta)
    latent = rms_norm(x @ p.w_dkv, p.norm_kv)  # (B, S, kv_lora)
    k_rope = apply_rope((x @ p.w_kr)[:, :, None, :], pos, rope_theta)
    k_nope = split_heads(latent @ p.w_uk, n_heads, nd)
    v = split_heads(latent @ p.w_uv, n_heads, vd)
    qf = torch.cat([q_nope, q_rope], dim=-1)
    kf = torch.cat([k_nope, k_rope.expand(b, s, n_heads, rd)], dim=-1)
    if sh is not None:
        qf, kf, v = sh.act_bthd(qf), sh.act_bthd(kf), sh.act_bthd(v)
    kw = dict(q_chunk=attn_chunk, k_chunk=attn_chunk) if attn_chunk else {}
    out = flash_attention(qf, kf, v, causal=True, p_dtype=p_dtype, **kw)
    return out.reshape(b, s, n_heads * vd) @ p.wo


def mla_decode(p: MLAParams, x, latent_cache, krope_cache, pos, *, n_heads,
               mla, rope_theta):
    """Absorbed-form decode: the cache holds the latent and the rope key
    only; W_uk is absorbed into q and W_uv applied after the softmax, in
    float32.  The token's latent and rope key are written into the caches
    at ``pos`` in place (the reference returns new arrays).  Returns
    (output, latent_cache, krope_cache)."""
    b = x.shape[0]
    nd, rd, vd = mla.qk_nope_dim, mla.qk_rope_dim, mla.v_head_dim
    lora = mla.kv_lora
    q = split_heads(x @ p.wq, n_heads, nd + rd)
    q_nope, q_rope = q[..., :nd], q[..., nd:]
    pos = torch.as_tensor(pos, device=x.device)
    posb = pos.reshape(1, 1).expand(b, 1)
    q_rope = apply_rope(q_rope, posb, rope_theta)
    lat = rms_norm(x @ p.w_dkv, p.norm_kv)  # (B, 1, lora)
    kr = apply_rope((x @ p.w_kr)[:, :, None, :], posb, rope_theta)[:, :, 0]
    write_at(latent_cache, pos, lat)
    write_at(krope_cache, pos, kr)
    # absorb W_uk into q: q_lat[h] = q_nope[h] @ W_uk[h]^T -> (B, 1, H, lora)
    wuk = split_heads(p.w_uk, n_heads, nd)
    q_lat = torch.einsum("bqhn,lhn->bqhl", q_nope.float(), wuk.float())
    smax = latent_cache.shape[1]
    scale = float(1.0 / torch.sqrt(torch.tensor(nd + rd,
                                                dtype=torch.float32)))
    lat_all = latent_cache.float()
    s_lat = torch.einsum("bqhl,bsl->bhqs", q_lat, lat_all)
    s_rope = torch.einsum("bqhr,bsr->bhqs", q_rope.float(),
                          krope_cache.float())
    s = (s_lat + s_rope) * scale
    ok = torch.arange(smax, device=x.device) < pos + 1
    s = torch.where(ok[None, None, None, :], s, NEG_INF)
    pattn = torch.softmax(s, dim=-1)
    ctx_lat = torch.einsum("bhqs,bsl->bqhl", pattn, lat_all)
    wuv = split_heads(p.w_uv, n_heads, vd)
    out = torch.einsum("bqhl,lhv->bqhv", ctx_lat, wuv.float())
    out = out.reshape(b, 1, n_heads * vd).to(x.dtype)
    return out @ p.wo, latent_cache, krope_cache
