"""Fused online-softmax attention (flash) on ``(BH, S, D)`` q and k and a
``(BH, S, Dv)`` v, ``Dv <= D``.

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


def flash_attention_fused_plain(q, k, v, causal: bool = True,
                                q_blk: int = 128, k_blk: int = 128):
    """The plain PyTorch version: the blockwise online-softmax loop over kv
    blocks in ascending order, all query blocks at once.  A query block
    takes part in kv block ``ki`` only when the reference's kernel would
    run that step (causal: ``ki*k_blk <= qi*q_blk + q_blk - 1``)."""
    q_blk, k_blk = _blocks(q, k, v, q_blk, k_blk)
    bh, s, d = q.shape
    scale = 1.0 / (d ** 0.5)
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full((bh, s, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((bh, s, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((bh, s, v.shape[2]), dtype=torch.float32,
                      device=q.device)
    pos = torch.arange(s, device=q.device)
    for k0 in range(0, s, k_blk):
        r0 = (k0 // q_blk) * q_blk if causal else 0
        sc = torch.matmul(qf[:, r0:], kf[:, k0:k0 + k_blk].transpose(1, 2))
        sc = sc * scale
        if causal:
            ok = pos[None, k0:k0 + k_blk] <= pos[r0:, None]
            sc = torch.where(ok, sc, NEG_INF)
        m_prev = m[:, r0:]
        m_new = torch.maximum(m_prev, sc.amax(-1, keepdim=True))
        p = torch.exp(sc - m_new)
        corr = torch.exp(m_prev - m_new)
        l[:, r0:] = l[:, r0:] * corr + p.sum(-1, keepdim=True)
        acc[:, r0:] = acc[:, r0:] * corr + torch.matmul(p,
                                                        vf[:, k0:k0 + k_blk])
        m[:, r0:] = m_new
    return (acc / l.clamp_min(1e-30)).to(q.dtype)


def _flash_attention_cuda(q, k, v, causal: bool = True, q_blk: int = 128,
                          k_blk: int = 128):
    _blocks(q, k, v, q_blk, k_blk)
    ops.expect_float(q, 3, "q")
    ops.expect(k, q.dtype, 3, "k")
    ops.expect(v, q.dtype, 3, "v")
    ops.same_device(("q", q), ("k", k), ("v", v))
    bh, s, d = q.shape
    dv = v.shape[2]
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head dim {d}: the kernel takes D <= {MAX_HEAD_DIM}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "the flash-attention kernel has no backward (ROADMAP Queue A "
            "item 12: training with K7); call it under torch.no_grad()")
    out = torch.empty((bh, s, dv), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    name, path = KERNELS[q.dtype]
    kernel = getattr(library(), name)
    with torch.cuda.device(q.device):
        rc = kernel(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    bh, s, d, dv, int(bool(causal)), 1.0 / (d ** 0.5),
                    torch.cuda.current_stream().cuda_stream)
    ops.check_launch("flash_attention_fused", rc, path)
    return out


def flash_attention_fused(q, k, v, causal: bool = True, q_blk: int = 128,
                          k_blk: int = 128):
    """Flash attention on ``(BH, S, D)`` q and k and ``(BH, S, Dv)`` v: the
    plain version on the CPU, the dtype's kernel on CUDA (q, k and v
    float32 or bfloat16 of one dtype, Dv <= D <= 192).  ``q_blk`` and
    ``k_blk`` keep the reference's divisibility contract; the kernels' own
    tiles are their choice."""
    return ops.dispatch(flash_attention_fused_plain, _flash_attention_cuda,
                        q, k, v, causal, q_blk, k_blk)
