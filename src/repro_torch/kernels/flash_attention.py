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
128-wide head.

A call whose inputs need a gradient goes through ``_FlashAttention``, a
``torch.autograd.Function``, on both devices.  Its forward also saves the
float32 row log-sum-exp ``lse = m + log(l)`` of the scaled scores, ``(BH,
Sq)`` (the kernels write it only when they are given a pointer for it, so a
call without a gradient launches as before); its backward is a kernel on
CUDA and ``flash_attention_masked_bwd_plain`` on the CPU.  On CUDA the
dtype and widths choose the backward kernel (``bwd_route``): bfloat16 with
D up to the source's ``kMaxD`` (128), or with D up to ``kWideD`` (192) and
Dv up to ``kWideDV`` (128), MLA's qk 192 / v 128, goes to
``csrc/flash_attention_bwd_wgmma.cu`` (every product on the tensor cores,
P and dS carried in three bfloat16 terms; MLA's build streams 32-query
tiles through its dK/dV pass, ``kWideBT``, so that dK's 192 columns fit
the registers); float32, and the other bfloat16 heads past 128, to
``csrc/flash_attention_bwd.cu`` (float32 on the CUDA cores).
Both are FlashAttention-2's schedule: a Delta pre-pass, a dK/dV pass over
key blocks, a dQ pass over query blocks, no atomics, so a gradient is the
same bits run to run; counted as ``flash_attention_bwd``, one count a
backward, with its route.  The reference has no Pallas backward: its
training differentiates the chunked attention with XLA.

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
# the backward's C entry point on each route
BWD_KERNELS = {"wgmma": "repro_flash_attention_bwd_wgmma",
               "cuda_cores": "repro_flash_attention_bwd"}


def wgmma_constants() -> dict:
    """The bf16 kernel's integer constants, read from its source
    (``_build.source_constants``): ``kPTerms``, the bf16 terms P is carried
    in (p1 = bf16(p), p2 = bf16(p - p1), ...), ``kWG``, ``kBK``,
    ``kStages``."""
    return source_constants("flash_attention_wgmma.cu")


def bwd_constants() -> dict:
    """The bf16 backward kernel's integer constants, read from its source:
    ``kTerms``, the bf16 terms P and dS are carried in; ``kRows``, the keys
    (dK/dV pass) or queries (dQ pass) of a block, 64 a warpgroup; ``kBT``,
    the queries or keys of a streamed tile; ``kMaxD``, the widest head of
    its square builds; ``kWideD`` and ``kWideDV``, the qk and value widths
    of MLA's build, whose dK/dV pass streams ``kWideBT``-query tiles."""
    return source_constants("flash_attention_bwd_wgmma.cu")


def bwd_route(dtype: torch.dtype, d: int, dv: int) -> str:
    """The backward kernel a CUDA call with ``dtype`` operands, qk width
    ``d`` and value width ``dv <= d`` launches: ``"wgmma"`` (bfloat16 with
    ``d`` up to ``kMaxD``, or with ``d`` up to ``kWideD`` and ``dv`` up to
    ``kWideDV``: MLA's 192 / 128; tensor cores) or ``"cuda_cores"``
    (float32, and the other bfloat16 heads past ``kMaxD``: their dK/dV
    pass would spill past 255 registers a thread)."""
    c = bwd_constants()
    if dtype == torch.bfloat16 and (
            d <= c["kMaxD"] or (d <= c["kWideD"] and dv <= c["kWideDV"])):
        return "wgmma"
    return "cuda_cores"


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


def bwd_widths(d: int, dv: int) -> tuple:
    """The template arguments (qk width, value width, the dK/dV pass's query
    tile) of the bf16 backward build a call with qk width ``d`` and value
    width ``dv`` launches: MLA's ``(kWideD, kWideDV, kWideBT)`` past
    ``kMaxD``, else D rounded up to a multiple of 32 for both widths (V
    zero-filled past ``dv``) and ``kBT``."""
    c = bwd_constants()
    if d > c["kMaxD"]:
        return c["kWideD"], c["kWideDV"], c["kWideBT"]
    dq = -(-d // 32) * 32
    return dq, dq, c["kBT"]


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


def _key_blocks(sq, causal, window, q_offset, kvl, k_blk):
    """The ``k_blk``-key blocks ``(k0, k1)`` the plain versions visit: from
    the block of the first key any query may see to that of the last."""
    lo = max(0, q_offset - window + 1) if window > 0 else 0
    hi = min(kvl, q_offset + sq) if causal else kvl
    return [(k0, min(k0 + k_blk, kvl))
            for k0 in range(lo - lo % k_blk, hi, k_blk)]


def _valid(sq, k0, k1, causal, window, q_offset, device):
    """The ``(Sq, k1 - k0)`` mask of valid (query, key) pairs."""
    qpos = q_offset + torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(k0, k1, device=device)[None, :]
    ok = kpos <= qpos if causal else torch.ones_like(kpos <= qpos)
    if window > 0:
        ok = ok & (kpos > qpos - window)
    return ok


def flash_attention_masked_plain(q, k, v, causal: bool = True,
                                 window: int = 0, q_offset: int = 0,
                                 kv_len=None, k_blk: int = 128,
                                 with_lse: bool = False):
    """The plain PyTorch version of the masked kernel: the online-softmax
    loop over ``k_blk``-key blocks in ascending order, all queries at once,
    from the block of the first key any query may see to that of the
    last.  ``with_lse`` also returns the float32 row log-sum-exp ``m +
    log(l)``, ``(BH, Sq)``, as the kernels' forward saves it."""
    kvl = _masked_shapes(q, k, v, causal, window, q_offset, kv_len)
    bh, sq, d = q.shape
    scale = 1.0 / (d ** 0.5)
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full((bh, sq, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((bh, sq, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((bh, sq, v.shape[2]), dtype=torch.float32,
                      device=q.device)
    for k0, k1 in _key_blocks(sq, causal, window, q_offset, kvl, k_blk):
        sc = torch.matmul(qf, kf[:, k0:k1].transpose(1, 2)) * scale
        ok = _valid(sq, k0, k1, causal, window, q_offset, q.device)
        sc = torch.where(ok, sc, NEG_INF)
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        p = torch.exp(sc - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + torch.matmul(p, vf[:, k0:k1])
        m = m_new
    out = (acc / l.clamp_min(1e-30)).to(q.dtype)
    if with_lse:
        return out, (m + torch.log(l))[..., 0]
    return out


def flash_attention_masked_bwd_plain(q, k, v, o, lse, do, causal: bool = True,
                                     window: int = 0, q_offset: int = 0,
                                     kv_len=None, k_blk: int = 128):
    """The plain PyTorch version of the backward kernel: ``(dq, dk, dv)`` in
    ``q``'s dtype from the forward's output ``o`` and row log-sum-exp
    ``lse`` and the output's gradient ``do``.  The same blockwise equations
    in float32: ``Delta = sum(do * o)`` a row, then for each ``k_blk``-key
    block the forward visits, ``P = exp(S * scale - lse)`` (0 on invalid
    pairs), ``dV = P^T.dO``, ``dS = P * (dO.V^T - Delta)``, ``dQ += dS.K``
    and ``dK = dS^T.Q``; dQ and dK are scaled once, at the end."""
    kvl = _masked_shapes(q, k, v, causal, window, q_offset, kv_len)
    sq, d = q.shape[1], q.shape[2]
    scale = 1.0 / (d ** 0.5)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    delta = (dof * o.float()).sum(-1, keepdim=True)
    lse = lse[..., None]
    dq = torch.zeros_like(qf)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    for k0, k1 in _key_blocks(sq, causal, window, q_offset, kvl, k_blk):
        sc = torch.matmul(qf, kf[:, k0:k1].transpose(1, 2)) * scale
        ok = _valid(sq, k0, k1, causal, window, q_offset, q.device)
        p = torch.where(ok, torch.exp(sc - lse), 0.0)
        dv[:, k0:k1] = torch.matmul(p.transpose(1, 2), dof)
        ds = p * (torch.matmul(dof, vf[:, k0:k1].transpose(1, 2)) - delta)
        dq = dq + torch.matmul(ds, kf[:, k0:k1])
        dk[:, k0:k1] = torch.matmul(ds.transpose(1, 2), qf)
    return ((dq * scale).to(q.dtype), (dk * scale).to(q.dtype),
            dv.to(q.dtype))


def flash_attention_fused_plain(q, k, v, causal: bool = True,
                                q_blk: int = 128, k_blk: int = 128):
    """The plain PyTorch version of the unmasked call: the reference's
    divisibility contract, then ``flash_attention_masked_plain`` over
    kv blocks of ``k_blk``."""
    _, k_blk = _blocks(q, k, v, q_blk, k_blk)
    return flash_attention_masked_plain(q, k, v, causal, k_blk=k_blk)


def _check_operands(q, k, v):
    ops.expect_float(q, 3, "q")
    ops.expect(k, q.dtype, 3, "k")
    ops.expect(v, q.dtype, 3, "v")
    ops.same_device(("q", q), ("k", k), ("v", v))
    if q.shape[2] > MAX_HEAD_DIM:
        raise ValueError(f"head dim {q.shape[2]}: the kernel takes D <= "
                         f"{MAX_HEAD_DIM}")


def _launch(q, k, v, causal, window, q_offset, kv_len, with_lse=False):
    """One launch of the dtype's kernel; the output ``(BH, Sq, Dv)``, and
    with ``with_lse`` the float32 row log-sum-exp ``(BH, Sq)`` too."""
    _check_operands(q, k, v)
    bh, sq, d = q.shape
    sk, dv = k.shape[1], v.shape[2]
    out = torch.empty((bh, sq, dv), dtype=q.dtype, device=q.device)
    lse = (torch.empty((bh, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if out.numel():
        name, path = KERNELS[q.dtype]
        kernel = getattr(library(), name)
        with torch.cuda.device(q.device):
            rc = kernel(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), 0 if lse is None else lse.data_ptr(),
                        bh, sq, sk, d, dv, int(bool(causal)), q_offset,
                        window, kv_len, 1.0 / (d ** 0.5),
                        torch.cuda.current_stream().cuda_stream)
        ops.check_launch("flash_attention_fused", rc, path)
    return (out, lse) if with_lse else out


def _launch_bwd(q, k, v, o, lse, do, causal, window, q_offset, kv_len,
                route=None):
    """One call of the backward kernel (its three launches); ``(dq, dk,
    dv)``.  ``route`` (default ``bwd_route``'s) names the kernel: the
    CUDA-core kernel takes every call, the tensor-core one the bf16 calls
    ``bwd_route`` sends it."""
    _check_operands(q, k, v)
    ops.expect(o, q.dtype, 3, "o")
    ops.expect(do, q.dtype, 3, "do")
    ops.expect(lse, torch.float32, 2, "lse")
    ops.same_device(("q", q), ("o", o), ("do", do), ("lse", lse))
    bh, sq, d = q.shape
    sk, dv = k.shape[1], v.shape[2]
    if (o.shape != (bh, sq, dv) or do.shape != o.shape
            or lse.shape != (bh, sq)):
        raise ValueError(f"o and do of (BH, Sq, Dv) = {(bh, sq, dv)} and lse "
                         f"of (BH, Sq) expected; got {tuple(o.shape)}, "
                         f"{tuple(do.shape)}, {tuple(lse.shape)}")
    dq, dk, dvv = (torch.empty_like(q), torch.empty_like(k),
                   torch.empty_like(v))
    if q.numel() == 0:
        return dq, dk, dvv
    delta = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    path = route or bwd_route(q.dtype, d, dv)
    if path == "wgmma" and bwd_route(q.dtype, d, dv) != "wgmma":
        c = bwd_constants()
        raise ValueError(f"the wgmma backward takes bf16 with D <= "
                         f"{c['kMaxD']}, or D <= {c['kWideD']} and Dv <= "
                         f"{c['kWideDV']}; got {q.dtype}, D {d}, Dv {dv}")
    # the CUDA-core kernel takes both dtypes and a flag for them
    flag = [int(q.dtype == torch.bfloat16)] if path == "cuda_cores" else []
    with torch.cuda.device(q.device):
        rc = getattr(library(), BWD_KERNELS[path])(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dvv.data_ptr(), delta.data_ptr(), bh, sq, sk, d, dv,
            int(bool(causal)), q_offset, window, kv_len, 1.0 / (d ** 0.5),
            *flag, torch.cuda.current_stream().cuda_stream)
    ops.check_launch("flash_attention_bwd", rc, path)
    return dq, dk, dvv


class _FlashAttention(torch.autograd.Function):
    """K7 with its backward: on CUDA the forward kernel with ``lse`` and the
    backward kernel, on the CPU their plain versions.  ``kv_len`` is the
    key limit already clipped to Sk (an int)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, kv_len):
        if ops.on_plain_device(q, k, v):
            out, lse = flash_attention_masked_plain(
                q, k, v, causal, window, q_offset, kv_len, with_lse=True)
        else:
            out, lse = _launch(q, k, v, causal, window, q_offset, kv_len,
                               with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = (causal, window, q_offset, kv_len)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        bwd = (flash_attention_masked_bwd_plain if ops.on_plain_device(q)
               else _launch_bwd)
        dq, dk, dv = bwd(q, k, v, out, lse, do.contiguous(), *ctx.mask)
        return dq, dk, dv, None, None, None, None


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _flash_attention_cuda(q, k, v, causal: bool = True, q_blk: int = 128,
                          k_blk: int = 128):
    _blocks(q, k, v, q_blk, k_blk)
    return _launch(q, k, v, causal, 0, 0, q.shape[1])


def _flash_attention_grad(q, k, v, causal: bool = True, q_blk: int = 128,
                          k_blk: int = 128):
    _blocks(q, k, v, q_blk, k_blk)
    return _FlashAttention.apply(q, k, v, causal, 0, 0, q.shape[1])


def flash_attention_fused(q, k, v, causal: bool = True, q_blk: int = 128,
                          k_blk: int = 128):
    """Flash attention on ``(BH, S, D)`` q and k and ``(BH, S, Dv)`` v: the
    plain version on the CPU, the dtype's kernel on CUDA (q, k and v
    float32 or bfloat16 of one dtype, Dv <= D <= 192).  ``q_blk`` and
    ``k_blk`` keep the reference's divisibility contract; the kernels' own
    tiles are their choice.  Under autograd both devices go through
    ``_FlashAttention`` (forward with ``lse``, then the backward)."""
    if _needs_grad(q, k, v):
        return _flash_attention_grad(q, k, v, causal, q_blk, k_blk)
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
    keys; a call in which some query sees no key raises ``ValueError``.
    Under autograd both devices go through ``_FlashAttention``."""
    if _needs_grad(q, k, v):
        kvl = _masked_shapes(q, k, v, causal, window, q_offset, kv_len)
        return _FlashAttention.apply(q, k, v, causal, window, q_offset, kvl)
    return ops.dispatch(flash_attention_masked_plain,
                        _flash_attention_masked_cuda, q, k, v, causal,
                        window, q_offset, kv_len)
