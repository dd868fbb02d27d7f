"""Fused online-softmax attention (flash) on ``(BH, S, D)`` q and k and a
``(BH, S, Dv)`` v, ``Dv <= D``; and its masked form on ``(BH, Sq, D)`` q,
``(BH, Sk, D)`` k and ``(BH, Sk, Dv)`` v.

Counterpart of ``repro.kernels.flash_attention.flash_attention_fused``
(which takes Dv == D; the model's chunked attention, which this kernel
stands in for, takes any Dv, and MLA's prefill sends qk 192 / v 128): the
scores of one query block against one kv block at a time, a running max,
denominator and accumulator in float32, kv blocks in ascending order; a
causal call skips kv blocks wholly above the diagonal and masks the
diagonal block elementwise with -1e30.  The output is ``acc / max(l,
1e-30)`` in ``q``'s dtype, ``(BH, S, Dv)``.  K and V come already expanded
to the query head count.

The scale is ``1/sqrt(D)``, D the qk width, computed in double and rounded
once to float32, as the Pallas kernel's ``1.0 / (d ** 0.5)``.  (The
model's chunked attention computes ``1/sqrt(float32(D))``; for D = 96 the
two differ by one float32 ulp, a relative 6e-8 on every score.)

On CUDA the dtype chooses the kernel (``route``): bfloat16 inputs go to
``csrc/flash_attention_wgmma.cu``, both products on the tensor cores
(``wgmma``, float32 accumulators, P carried in three bfloat16 terms so that
it keeps float32 precision); float32 inputs to ``csrc/flash_attention.cu``,
float32 on the CUDA cores.  Either is one launch per call, for D up to 192
(``MAX_HEAD_DIM``); the bf16 kernel's qk and value widths are template
parameters of their own, so MLA's 192 / 128 keeps the accumulator of a
128-wide head.  Neither has a backward: on CUDA, a call whose inputs need
a gradient raises rather than return an output without one.

``flash_attention_masked`` is the same kernel under the masks of the
model's chunked attention (``repro.models.attention``'s ``_mask_val`` and
``kv_valid_len``): key j is valid for query i iff ``j < kv_len``, ``j <= i
+ q_offset`` when causal, and ``j > i + q_offset - window`` when ``window >
0``, for any Sq, Sk >= 1 (a ragged S needs no padding: keys past Sk are
simply invalid).  Both kernels run the kv tiles from the first key any
query of a block may see to the last, skipping the tiles wholly outside a
window as they skip those above a causal diagonal.  A call in which some
query has no valid key raises (``rows_without_keys``): the reference gives
such a row the mean of the masked values, which no model here asks for.
``flash_attention_fused`` is its unmasked case (Sq == Sk, no window, no
offset), under the reference's block-divisibility contract.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.kernels._build import library, source_constants

NEG_INF = -1e30
MAX_HEAD_DIM = 192  # the qk width both kernels take (MLA: 128 + 64)
# the kernel each dtype goes to on CUDA: (C entry point, route)
KERNELS = {torch.bfloat16: ("repro_flash_attention_wgmma", "wgmma"),
           torch.float32: ("repro_flash_attention", "cuda_cores")}


def wgmma_constants() -> dict:
    """The bf16 kernel's integer constants, read from its source
    (``_build.source_constants``): ``kPTerms``, the bf16 terms P is carried
    in (p1 = bf16(p), p2 = bf16(p - p1), ...), ``kWG``, ``kBK``,
    ``kStages``."""
    return source_constants("flash_attention_wgmma.cu")


def route(dtype: torch.dtype) -> str:
    """The kernel a CUDA call with ``dtype`` inputs launches: ``"wgmma"``
    (bfloat16, tensor cores) or ``"cuda_cores"`` (float32)."""
    return KERNELS[dtype][1]


def wgmma_widths(d: int, dv: int) -> tuple:
    """The (qk, value) tile widths of the bf16 kernel a call with qk width
    ``d`` and value width ``dv`` launches: D rounded up to a multiple of 32,
    and the value width 128 where that passes 128 and ``dv <= 128`` (MLA's
    192 / 128), else the qk width (V zero-filled past ``dv``)."""
    dq = -(-d // 32) * 32
    return dq, 128 if dq > 128 and dv <= 128 else dq


def rows_without_keys(sq: int, sk: int, causal: bool = True,
                      window: int = 0, q_offset: int = 0,
                      kv_len=None) -> bool:
    """True when some query of a masked call has no valid key.  Query i
    sees the keys ``[lo(i), hi(i))``, ``lo`` convex and ``hi`` concave in
    i, so ``hi - lo`` is least at the first or the last query."""
    kvl = sk if kv_len is None else min(int(kv_len), sk)

    def empty(i):
        p = i + q_offset
        lo = max(0, p - window + 1) if window > 0 else 0
        hi = min(kvl, p + 1) if causal else kvl
        return hi <= lo

    return sq < 1 or sk < 1 or empty(0) or empty(sq - 1)


def _blocks(q, k, v, q_blk, k_blk):
    if (q.dim() != 3 or k.shape != q.shape or v.dim() != 3
            or v.shape[:2] != q.shape[:2] or v.shape[2] > q.shape[2]):
        raise ValueError(f"expected q and k of one shape (BH, S, D) and v of "
                         f"(BH, S, Dv) with Dv <= D; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    s = q.shape[1]
    q_blk, k_blk = min(q_blk, s), min(k_blk, s)
    assert s % q_blk == 0 and s % k_blk == 0, (s, q_blk, k_blk)
    return q_blk, k_blk


def _masked_shapes(q, k, v, causal, window, q_offset, kv_len) -> int:
    """Check a masked call's shapes and mask; return the key limit
    ``min(kv_len, Sk)``."""
    if (q.dim() != 3 or k.dim() != 3 or v.dim() != 3
            or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]
            or v.shape[:2] != k.shape[:2] or v.shape[2] > q.shape[2]):
        raise ValueError(f"expected q (BH, Sq, D), k (BH, Sk, D) and v (BH, "
                         f"Sk, Dv) with Dv <= D; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if window < 0:
        raise ValueError(f"window {window}: expected >= 0 (0: none)")
    sq, sk = q.shape[1], k.shape[1]
    if rows_without_keys(sq, sk, causal, window, q_offset, kv_len):
        raise ValueError(
            f"a query sees no key (Sq {sq}, Sk {sk}, causal {causal}, window "
            f"{window}, q_offset {q_offset}, kv_len {kv_len}); outside the "
            f"kernel's contract")
    return sk if kv_len is None else min(int(kv_len), sk)


def flash_attention_masked_plain(q, k, v, causal: bool = True,
                                 window: int = 0, q_offset: int = 0,
                                 kv_len=None, k_blk: int = 128):
    """The plain PyTorch version of the masked kernel: the online-softmax
    loop over ``k_blk``-key blocks in ascending order, all queries at once,
    from the block of the first key any query may see to that of the
    last."""
    kvl = _masked_shapes(q, k, v, causal, window, q_offset, kv_len)
    bh, sq, d = q.shape
    scale = 1.0 / (d ** 0.5)
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full((bh, sq, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((bh, sq, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((bh, sq, v.shape[2]), dtype=torch.float32,
                      device=q.device)
    qpos = q_offset + torch.arange(sq, device=q.device)[:, None]
    lo = max(0, q_offset - window + 1) if window > 0 else 0
    hi = min(kvl, q_offset + sq) if causal else kvl
    for k0 in range(lo - lo % k_blk, hi, k_blk):
        k1 = min(k0 + k_blk, kvl)
        sc = torch.matmul(qf, kf[:, k0:k1].transpose(1, 2)) * scale
        kpos = torch.arange(k0, k1, device=q.device)[None, :]
        ok = kpos <= qpos if causal else torch.ones_like(kpos <= qpos)
        if window > 0:
            ok = ok & (kpos > qpos - window)
        sc = torch.where(ok, sc, NEG_INF)
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        p = torch.exp(sc - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + torch.matmul(p, vf[:, k0:k1])
        m = m_new
    return (acc / l.clamp_min(1e-30)).to(q.dtype)


def flash_attention_fused_plain(q, k, v, causal: bool = True,
                                q_blk: int = 128, k_blk: int = 128):
    """The plain PyTorch version of the unmasked call: the reference's
    divisibility contract, then ``flash_attention_masked_plain`` over
    kv blocks of ``k_blk``."""
    _, k_blk = _blocks(q, k, v, q_blk, k_blk)
    return flash_attention_masked_plain(q, k, v, causal, k_blk=k_blk)


def _launch(q, k, v, causal, window, q_offset, kv_len):
    """One launch of the dtype's kernel; the output ``(BH, Sq, Dv)``."""
    ops.expect_float(q, 3, "q")
    ops.expect(k, q.dtype, 3, "k")
    ops.expect(v, q.dtype, 3, "v")
    ops.same_device(("q", q), ("k", k), ("v", v))
    bh, sq, d = q.shape
    sk, dv = k.shape[1], v.shape[2]
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head dim {d}: the kernel takes D <= {MAX_HEAD_DIM}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "the flash-attention kernel has no backward (ROADMAP Queue A "
            "item 12: training with K7); call it under torch.no_grad()")
    out = torch.empty((bh, sq, dv), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    name, path = KERNELS[q.dtype]
    kernel = getattr(library(), name)
    with torch.cuda.device(q.device):
        rc = kernel(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    bh, sq, sk, d, dv, int(bool(causal)), q_offset, window,
                    kv_len, 1.0 / (d ** 0.5),
                    torch.cuda.current_stream().cuda_stream)
    ops.check_launch("flash_attention_fused", rc, path)
    return out


def _flash_attention_cuda(q, k, v, causal: bool = True, q_blk: int = 128,
                          k_blk: int = 128):
    _blocks(q, k, v, q_blk, k_blk)
    return _launch(q, k, v, causal, 0, 0, q.shape[1])


def flash_attention_fused(q, k, v, causal: bool = True, q_blk: int = 128,
                          k_blk: int = 128):
    """Flash attention on ``(BH, S, D)`` q and k and ``(BH, S, Dv)`` v: the
    plain version on the CPU, the dtype's kernel on CUDA (q, k and v
    float32 or bfloat16 of one dtype, Dv <= D <= 192).  ``q_blk`` and
    ``k_blk`` keep the reference's divisibility contract; the kernels' own
    tiles are their choice."""
    return ops.dispatch(flash_attention_fused_plain, _flash_attention_cuda,
                        q, k, v, causal, q_blk, k_blk)


def _flash_attention_masked_cuda(q, k, v, causal: bool = True,
                                 window: int = 0, q_offset: int = 0,
                                 kv_len=None):
    kvl = _masked_shapes(q, k, v, causal, window, q_offset, kv_len)
    return _launch(q, k, v, causal, window, q_offset, kvl)


def flash_attention_masked(q, k, v, causal: bool = True, window: int = 0,
                           q_offset: int = 0, kv_len=None):
    """Flash attention on ``(BH, Sq, D)`` q, ``(BH, Sk, D)`` k and ``(BH,
    Sk, Dv)`` v under the chunked attention's masks (the module's
    docstring): the plain version on the CPU, the dtype's kernel on CUDA.
    ``kv_len`` (an int or a 0-d tensor, read once on the host) limits the
    keys; a call in which some query sees no key raises ``ValueError``."""
    return ops.dispatch(flash_attention_masked_plain,
                        _flash_attention_masked_cuda, q, k, v, causal,
                        window, q_offset, kv_len)
