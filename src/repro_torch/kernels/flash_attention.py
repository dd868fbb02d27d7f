"""Fused online-softmax attention (flash) on ``(BH, S, D)`` q and k and a
``(BH, S, Dv)`` v; and its masked form on ``(BH, Sq, D)`` q, ``(BH, Sk,
D)`` k and ``(BH, Sk, Dv)`` v, any D and Dv.

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

On CUDA the dtype and widths choose the kernel (``route``): bfloat16 and
float16 inputs with a qk width up to 384 go to the tensor cores
(``csrc/flash_wgmma.cuh``, built by ``flash_attention_wgmma.cu`` for bf16
and ``flash_attention_wgmma_f16.cu`` for float16 up to 256 columns, and by
``flash_attention_wgmma_wide.cu`` for both past that, its value columns in
slabs; ``wgmma``, float32 accumulators, P carried in three bf16 or two f16
terms so that it keeps float32 precision; ``"wgmma_p1"``, one term, under
``p_dtype``); float32 inputs, and 16-bit qk widths past 384, to
``csrc/flash_attention.cu``, float32 on the CUDA cores (``"cuda_cores"``
up to 192 columns, ``"cuda_cores_slabs"`` past that: D and Dv in 64-column
slabs).  Either is one launch per call; the tensor-core kernel's qk and
value widths are template parameters of their own, so MLA's 192 / 128
keeps the accumulator of a 128-wide head.

``p_dtype=torch.bfloat16`` is the reference's ``p_dtype``
(``repro.models.attention.flash_attention``): ``l`` sums the float32
probabilities, then P and V are rounded to bf16 and P.V is summed in
float32.

A query with no valid key: every score of its row is exactly -1e30 in the
reference's chunked loop, so its ``m`` stays -1e30 and ``p = 1`` on every
key of every chunk it visits, padded keys included.  Its output is
``sum_{j < Sk} v_j / (ceil(Sk / kc) * kc)``, ``kc = min(k_chunk, Sk)``
(v rounded to bf16 under ``p_dtype``), which depends on the reference's
key chunk, so the masked entry takes ``k_chunk``.  Such queries are a
prefix and a suffix of the queries (``keyless_rows``); after the attention
kernel a column-sum kernel (``repro_flash_keyless`` in
``csrc/flash_attention.cu``, counted as ``flash_attention_keyless``: a
cluster of blocks a (BH, 128-column slab) splits the rows, its partial
sums added in a fixed order) writes their rows, and their ``lse`` as
+1e30, so that the backward's P is 0 on them; in the backward it first
sums their ``dV_j += sum_i dO_i / den`` (the same for every key ``j <
Sk``) in float32, and the backward kernel adds it to dV before it rounds
dV; dQ and dK get nothing from them.

A call whose inputs need a gradient goes through ``_FlashAttention``, a
``torch.autograd.Function``, on both devices.  Its forward also saves the
float32 row log-sum-exp ``lse = m + log(l)`` of the scaled scores, ``(BH,
Sq)`` (the kernels write it only when they are given a pointer for it, so a
call without a gradient launches as before); its backward is a kernel on
CUDA and ``flash_attention_masked_bwd_plain`` on the CPU.  On CUDA the
dtype and widths choose the backward kernel (``bwd_route``): bfloat16 and
float16 with D and Dv up to 256, with or without ``p_dtype`` and queries
without a key, go to the tensor cores (``csrc/flash_bwd_wgmma.cuh``,
every product on the tensor cores, P and dS carried in three bf16 or two
f16 terms; built by ``flash_attention_bwd_wgmma.cu`` and its ``_f16``
twin up to MLA's qk 192 / v 128, whose build streams 32-query tiles
through its dK/dV pass, ``kWideBT``, so that dK's 192 columns fit the
registers, and by ``flash_attention_bwd_wgmma_wide.cu`` for the other
heads up to 256, whose dK/dV pass computes dK and dV in blocks of their
own); every other call to ``csrc/flash_attention_bwd.cu`` (float32 on the
CUDA cores, any widths: ``"cuda_cores"`` up to 192 columns,
``"cuda_cores_slabs"`` past that).
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
window as they skip those above a causal diagonal.
``flash_attention_fused`` is its unmasked case (Sq == Sk, no window, no
offset), under the reference's block-divisibility contract.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.kernels._build import library, source_constants

NEG_INF = -1e30
KEYLESS_LSE = 1e30  # the lse of a row without keys: its backward P is 0
# the dtypes the tensor-core kernels take
TENSOR_CORE_DTYPES = (torch.bfloat16, torch.float16)
# the forward's C entry point on each route: the tensor-core routes by the
# build family (``wgmma_entry``), the CUDA-core kernel any call
KERNELS = {"wgmma": ("repro_flash_attention_wgmma",
                     "repro_flash_attention_wgmma_f16",
                     "repro_flash_attention_wgmma_wide"),
           "cuda_cores": ("repro_flash_attention",)}
KERNELS["wgmma_p1"] = KERNELS["wgmma"]
KERNELS["cuda_cores_slabs"] = KERNELS["cuda_cores"]
# the backward's C entry point on each route, as the forward's
BWD_KERNELS = {"wgmma": ("repro_flash_attention_bwd_wgmma",
                         "repro_flash_attention_bwd_wgmma_f16",
                         "repro_flash_attention_bwd_wgmma_wide"),
               "cuda_cores": ("repro_flash_attention_bwd",)}
BWD_KERNELS["cuda_cores_slabs"] = BWD_KERNELS["cuda_cores"]


def wgmma_constants() -> dict:
    """The tensor-core forward's integer constants, read from its sources
    (``_build.source_constants``: ``csrc/flash_wgmma_common.cuh`` and
    ``csrc/flash_wgmma.cuh``): ``kPTerms`` and ``kPTermsF16``, the bf16
    and f16 terms P is carried in (t1 = T(p), t2 = T(p - t1), ...; one
    under ``p_dtype``), ``kWG``, ``kBK`` (its key tile), ``kStages``,
    ``kMaxD`` (the widest head of its square builds), ``kSlabD`` /
    ``kSlabDV`` and ``kWideD`` / ``kWideDV`` (the qk width and value slab
    of its two wide builds)."""
    return {**source_constants("flash_wgmma_common.cuh"),
            **source_constants("flash_wgmma.cuh")}


def bwd_constants() -> dict:
    """The tensor-core backward's integer constants, read from its sources
    (``csrc/flash_wgmma_common.cuh`` and ``csrc/flash_bwd_wgmma.cuh``):
    ``kTerms`` and ``kTermsF16``, the bf16 and f16 terms P and dS are
    carried in; ``kRows``, the keys (dK/dV pass) or queries (dQ pass) of a
    block, 64 a warpgroup; ``kBT``, the queries or keys of a streamed tile;
    ``kMaxD``, the widest head of its square builds; ``kNarrowD`` /
    ``kNarrowDV``, the widths of its Dv > D build; ``kWideD`` and
    ``kWideDV``, the qk and value widths of MLA's build, whose dK/dV pass
    streams ``kWideBT``-query tiles; ``kSplitD``, the widths of the split
    build (dK and dV in blocks of their own, ``kSplitBT``-row tiles in
    both passes)."""
    return {**source_constants("flash_wgmma_common.cuh"),
            **source_constants("flash_bwd_wgmma.cuh")}


def _cuda_cores(d: int, dv: int) -> str:
    """The CUDA-core kernels' route: one block a query or key tile up to the
    source's ``kMaxD`` (192) columns, 64-column slabs past it."""
    wide = max(d, dv) > source_constants("flash_attention.cu")["kMaxD"]
    return "cuda_cores_slabs" if wide else "cuda_cores"


def bwd_route(dtype: torch.dtype, d: int, dv: int) -> str:
    """The backward kernel a CUDA call with ``dtype`` operands, qk width
    ``d`` and value width ``dv`` launches: ``"wgmma"`` (bfloat16 and
    float16 with both widths up to the source's ``kSplitD``, 256; tensor
    cores), else the CUDA-core kernel (``_cuda_cores``: float32, and heads
    past 256).  ``p_dtype`` and queries without a key choose no route: both
    kernels take them."""
    if dtype in TENSOR_CORE_DTYPES and max(d, dv) <= bwd_constants()["kSplitD"]:
        return "wgmma"
    return _cuda_cores(d, dv)


def route(dtype: torch.dtype, d: int = 1, dv: int = 1, p_dtype=None) -> str:
    """The kernel a CUDA call with ``dtype`` inputs, qk width ``d`` and
    value width ``dv`` launches: ``"wgmma"`` (bfloat16 and float16 with the
    qk width up to the source's ``kWideD``, 384, any value width, in slabs
    past 256; tensor cores), ``"wgmma_p1"`` (the same with one P term,
    under ``p_dtype``), else the CUDA-core kernel (``"cuda_cores"``, or
    ``"cuda_cores_slabs"`` past 192 columns): float32, and qk widths past
    384."""
    if dtype in TENSOR_CORE_DTYPES and d <= wgmma_constants()["kWideD"]:
        return "wgmma" if p_dtype is None else "wgmma_p1"
    return _cuda_cores(d, dv)


def wgmma_widths(d: int, dv: int) -> tuple:
    """The (qk, value) tile widths of the tensor-core build a call with qk
    width ``d`` and value width ``dv`` launches: up to ``kMaxD`` (256) the
    wider of the two rounded up to a multiple of 32 for both (V, or Q and
    K, zero-filled past their width), 256 past 192, and the value width 128
    where the qk width passes 128 and ``dv <= 128`` (MLA's 192 / 128);
    past 256 ``(kSlabD, kSlabDV)`` for ``d <= kSlabD`` (320 / 160), else
    ``(kWideD, kWideDV)`` (384 / 128), the values in slabs of the value
    width."""
    c = wgmma_constants()
    if max(d, dv) > c["kMaxD"]:
        if d <= c["kSlabD"]:
            return c["kSlabD"], c["kSlabDV"]
        return c["kWideD"], c["kWideDV"]
    dq = -(-max(d, dv) // 32) * 32
    if dq > 192:
        return 256, 256
    return dq, 128 if dq > 128 and dv <= 128 else dq


def wgmma_entry(kind: str, dtype: torch.dtype, d: int, dv: int) -> str:
    """The C entry point of the tensor-core build family a call takes:
    ``kind`` ``"fwd"`` (``KERNELS``) or ``"bwd"`` (``BWD_KERNELS``); the
    bf16 and the f16 sources up to ``kMaxD`` (the backward's: up to MLA's
    widths), the wide source past them, for both types."""
    if kind == "fwd":
        wide = max(d, dv) > wgmma_constants()["kMaxD"]
        names = KERNELS["wgmma"]
    else:
        wide = bwd_widths(d, dv)[0] == bwd_constants()["kSplitD"]
        names = BWD_KERNELS["wgmma"]
    return names[2] if wide else names[int(dtype == torch.float16)]


def bwd_widths(d: int, dv: int) -> tuple:
    """The template arguments (qk width, value width, the dK/dV pass's query
    tile) of the tensor-core backward build a call with qk width ``d`` and
    value width ``dv`` launches: up to ``kMaxD`` (128) D rounded up to a
    multiple of 32 for both widths (Dv, or D, zero-filled past its width)
    and ``kBT``, or ``(kNarrowD, kNarrowDV, kBT)`` for ``d <= 64 < dv``;
    MLA's ``(kWideD, kWideDV, kWideBT)`` for ``d <= 192`` and ``dv <=
    128``; else the split build ``(kSplitD, kSplitD, kSplitBT)``."""
    c = bwd_constants()
    wide = max(d, dv)
    if wide > c["kMaxD"]:
        if d <= c["kWideD"] and dv <= c["kWideDV"]:
            return c["kWideD"], c["kWideDV"], c["kWideBT"]
        return c["kSplitD"], c["kSplitD"], c["kSplitBT"]
    if d <= c["kNarrowD"] < dv:
        return c["kNarrowD"], c["kNarrowDV"], c["kBT"]
    dq = -(-wide // 32) * 32
    return dq, dq, c["kBT"]


def _key_range(p, kvl: int, causal: bool, window: int):
    """The keys ``[lo, hi)`` query position ``p`` (query i + q_offset) may
    see, elementwise on an int64 tensor of positions."""
    lo = (p - window + 1).clamp_min(0) if window > 0 else torch.zeros_like(p)
    hi = (p + 1).clamp(max=kvl) if causal else torch.full_like(p, kvl)
    return lo, hi


def keyless_rows(sq: int, sk: int, causal: bool = True, window: int = 0,
                 q_offset: int = 0, kv_len=None) -> tuple:
    """``(a, b)``: the queries ``[0, a)`` and ``[b, Sq)`` of a masked call
    have no valid key, every query of ``[a, b)`` has one.  Query i sees the
    keys ``[lo(i), hi(i))``, ``lo`` convex and ``hi`` concave in i, so the
    queries without a key are a prefix and a suffix.  In integers, on the
    host: with p = i + q_offset, ``[lo, hi)`` is ``[max(0, p - window + 1)
    or 0, min(p + 1, kv_len) or kv_len)``, which is not empty iff kv_len >
    0, p >= 0 where causal, and p <= kv_len + window - 2 under a window."""
    kvl = sk if kv_len is None else max(0, min(int(kv_len), sk))
    if kvl <= 0 or sq <= 0:
        return sq, sq
    a = max(0, -q_offset) if causal else 0
    b = min(sq, kvl + window - 1 - q_offset) if window > 0 else sq
    return (a, b) if a < b else (sq, sq)


def keyless_den(sk: int, k_chunk: int) -> int:
    """The denominator of a row without keys: every key of every chunk of
    ``min(k_chunk, Sk)`` keys the reference's chunked loop visits."""
    kc = min(k_chunk, sk)
    return -(-sk // kc) * kc


def _blocks(q, k, v, q_blk, k_blk):
    if (q.dim() != 3 or k.shape != q.shape or v.dim() != 3
            or v.shape[:2] != q.shape[:2]):
        raise ValueError(f"expected q and k of one shape (BH, S, D) and v of "
                         f"(BH, S, Dv); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    s = q.shape[1]
    q_blk, k_blk = min(q_blk, s), min(k_blk, s)
    assert s % q_blk == 0 and s % k_blk == 0, (s, q_blk, k_blk)
    return q_blk, k_blk


def _masked_shapes(q, k, v, window) -> None:
    """Check a masked call's shapes and window."""
    if (q.dim() != 3 or k.dim() != 3 or v.dim() != 3
            or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]
            or v.shape[:2] != k.shape[:2] or k.shape[1] < 1):
        raise ValueError(f"expected q (BH, Sq, D), k (BH, Sk, D) and v (BH, "
                         f"Sk, Dv) with Sk >= 1; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if window < 0:
        raise ValueError(f"window {window}: expected >= 0 (0: none)")


def _kv_limit(sk: int, kv_len) -> int:
    """The key limit ``kv_len`` clipped to ``[0, Sk]`` (``kv_len`` an int
    or a 0-d tensor, read once on the host)."""
    return sk if kv_len is None else max(0, min(int(kv_len), sk))


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


def _p_round(x: torch.Tensor, p_dtype) -> torch.Tensor:
    """``x`` (float32) rounded to ``p_dtype`` and back; as it is without."""
    return x if p_dtype is None else x.to(p_dtype).float()


def flash_attention_masked_plain(q, k, v, causal: bool = True,
                                 window: int = 0, q_offset: int = 0,
                                 kv_len=None, p_dtype=None,
                                 k_chunk: int = 1024, k_blk: int = 128,
                                 with_lse: bool = False):
    """The plain PyTorch version of the masked kernel: the online-softmax
    loop over ``k_blk``-key blocks in ascending order, all queries at once,
    from the block of the first key any query may see to that of the
    last; under ``p_dtype`` P and V rounded to it before P.V.  The rows of
    queries without a key get the reference's value for them (the module's
    docstring; ``k_chunk`` is the reference's key chunk).  ``with_lse``
    also returns the float32 row log-sum-exp ``m + log(l)``, ``(BH, Sq)``,
    as the kernels' forward saves it (+1e30 on a row without keys)."""
    _masked_shapes(q, k, v, window)
    bh, sq, d = q.shape
    sk = k.shape[1]
    kvl = _kv_limit(sk, kv_len)
    scale = 1.0 / (d ** 0.5)
    qf, kf, vf = q.float(), k.float(), _p_round(v.float(), p_dtype)
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
        acc = acc * corr + torch.matmul(_p_round(p, p_dtype), vf[:, k0:k1])
        m = m_new
    out = acc / l.clamp_min(1e-30)
    lse = (m + torch.log(l))[..., 0]
    a, b = keyless_rows(sq, sk, causal, window, q_offset, kv_len)
    if a > 0 or b < sq:
        mean = vf.sum(1, keepdim=True) / keyless_den(sk, k_chunk)
        out[:, :a] = mean
        out[:, b:] = mean
        lse[:, :a] = KEYLESS_LSE
        lse[:, b:] = KEYLESS_LSE
    out = out.to(q.dtype)
    return (out, lse) if with_lse else out


def flash_attention_masked_bwd_plain(q, k, v, o, lse, do, causal: bool = True,
                                     window: int = 0, q_offset: int = 0,
                                     kv_len=None, p_dtype=None,
                                     k_chunk: int = 1024, k_blk: int = 128):
    """The plain PyTorch version of the backward kernel: ``(dq, dk, dv)`` in
    ``q``'s dtype from the forward's output ``o`` and row log-sum-exp
    ``lse`` and the output's gradient ``do``.  The same blockwise equations
    in float32: ``Delta = sum(do * o)`` a row, then for each ``k_blk``-key
    block the forward visits, ``P = exp(S * scale - lse)`` (0 on invalid
    pairs and on rows without keys), ``dV = P^T.dO``, ``dS = P * (dO.V^T -
    Delta)``, ``dQ += dS.K`` and ``dK = dS^T.Q``; dQ and dK are scaled once,
    at the end.  Under ``p_dtype`` V in dO.V^T and P in P^T.dO are rounded
    to it (the rounding's gradient taken as the identity).  The queries
    without a key add ``sum_i dO_i / den`` to every key's dV."""
    _masked_shapes(q, k, v, window)
    sq, d = q.shape[1], q.shape[2]
    sk = k.shape[1]
    kvl = _kv_limit(sk, kv_len)
    scale = 1.0 / (d ** 0.5)
    qf, kf, dof = q.float(), k.float(), do.float()
    vf = _p_round(v.float(), p_dtype)
    delta = (dof * o.float()).sum(-1, keepdim=True)
    lse = lse[..., None]
    dq = torch.zeros_like(qf)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    for k0, k1 in _key_blocks(sq, causal, window, q_offset, kvl, k_blk):
        sc = torch.matmul(qf, kf[:, k0:k1].transpose(1, 2)) * scale
        ok = _valid(sq, k0, k1, causal, window, q_offset, q.device)
        p = torch.where(ok, torch.exp(sc - lse), 0.0)
        dv[:, k0:k1] = torch.matmul(_p_round(p, p_dtype).transpose(1, 2), dof)
        ds = p * (torch.matmul(dof, vf[:, k0:k1].transpose(1, 2)) - delta)
        dq = dq + torch.matmul(ds, kf[:, k0:k1])
        dk[:, k0:k1] = torch.matmul(ds.transpose(1, 2), qf)
    a, b = keyless_rows(sq, sk, causal, window, q_offset, kv_len)
    if a > 0 or b < sq:
        g = dof[:, :a].sum(1, keepdim=True) + dof[:, b:].sum(1, keepdim=True)
        dv = dv + g / keyless_den(sk, k_chunk)
    return ((dq * scale).to(q.dtype), (dk * scale).to(q.dtype),
            dv.to(q.dtype))


def flash_attention_fused_plain(q, k, v, causal: bool = True,
                                q_blk: int = 128, k_blk: int = 128):
    """The plain PyTorch version of the unmasked call: the reference's
    divisibility contract, then ``flash_attention_masked_plain`` over
    kv blocks of ``k_blk``."""
    _, k_blk = _blocks(q, k, v, q_blk, k_blk)
    return flash_attention_masked_plain(q, k, v, causal, k_blk=k_blk)


def _check_operands(q, k, v) -> int:
    """The operands' dtype code (``ops.expect_float``)."""
    code = ops.expect_float(q, 3, "q")
    ops.expect(k, q.dtype, 3, "k")
    ops.expect(v, q.dtype, 3, "v")
    ops.same_device(("q", q), ("k", k), ("v", v))
    return code


def _keyless(v, o, lse, sk, a, b, p_dtype, k_chunk, fwd):
    """One launch of the keyless pass on the queries ``[0, a)`` and ``[b,
    Sq)`` of a call with ``sk`` keys: their rows of ``o`` and ``lse``
    (``fwd``), or the float32 dV ``o`` (BH, Dv) every key gets from them
    (``v`` then the output's gradient)."""
    bh = o.shape[0]
    sq = o.shape[1] if fwd else v.shape[1]
    rc = ops.launch_on(
        o.device, library().repro_flash_keyless, v.data_ptr(), o.data_ptr(),
        0 if lse is None else lse.data_ptr(), bh, sq, sk, v.shape[2], a, b,
        float(keyless_den(sk, k_chunk)), int(p_dtype is not None),
        ops.DTYPE_CODES[v.dtype], int(fwd))
    ops.check_launch("flash_attention_keyless", rc, "fwd" if fwd else "bwd")


def _launch(q, k, v, causal, window, q_offset, kv_len, with_lse=False,
            p_dtype=None, k_chunk=1024, path=None):
    """One launch of the call's kernel (none when no query has a key) and,
    when some query has none, of the keyless pass; the output ``(BH, Sq,
    Dv)``, and with ``with_lse`` the float32 row log-sum-exp ``(BH, Sq)``
    too.  ``path`` (default ``route``'s) names the kernel: the CUDA-core
    kernel takes every call (``"cuda_cores"`` or ``"cuda_cores_slabs"``,
    by width), the tensor cores the calls ``route`` sends them."""
    code = _check_operands(q, k, v)
    _masked_shapes(q, k, v, window)
    if p_dtype not in (None, torch.bfloat16):
        raise ValueError(f"p_dtype {p_dtype}: the kernels round P to "
                         f"bfloat16 or not at all")
    bh, sq, d = q.shape
    sk, dv = k.shape[1], v.shape[2]
    kvl = _kv_limit(sk, kv_len)
    want = route(q.dtype, d, dv, p_dtype)
    if path is None:
        path = want
    elif path.startswith("cuda_cores"):
        path = _cuda_cores(d, dv)
    elif path != want:
        raise ValueError(f"route {path}: a {q.dtype} call of D {d}, Dv {dv} "
                         f"takes {want} or the CUDA cores")
    out = torch.empty((bh, sq, dv), dtype=q.dtype, device=q.device)
    lse = (torch.empty((bh, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if not out.numel():
        return (out, lse) if with_lse else out
    a, b = keyless_rows(sq, sk, causal, window, q_offset, kvl)
    if a < b:
        entry = (wgmma_entry("fwd", q.dtype, d, dv)
                 if path.startswith("wgmma") else KERNELS[path][0])
        with torch.cuda.device(q.device):
            rc = getattr(library(), entry)(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                0 if lse is None else lse.data_ptr(), bh, sq, sk, d, dv,
                int(bool(causal)), q_offset, window, kvl, 1.0 / (d ** 0.5),
                int(p_dtype is not None), code,
                torch.cuda.current_stream().cuda_stream)
        ops.check_launch("flash_attention_fused", rc, path)
    if a > 0 or b < sq:
        _keyless(v, out, lse, sk, a, b, p_dtype, k_chunk, True)
    return (out, lse) if with_lse else out


def _launch_bwd(q, k, v, o, lse, do, causal, window, q_offset, kv_len,
                p_dtype=None, k_chunk=1024, route=None):
    """One call of the backward kernel (its three launches) and, when some
    query has no key, first the keyless pass's, whose float32 dV the
    kernel adds before it rounds dV; ``(dq, dk, dv)``.  ``route`` (default
    ``bwd_route``'s) names the kernel: the CUDA-core kernel takes every
    call, the tensor-core one the calls ``bwd_route`` sends it."""
    code = _check_operands(q, k, v)
    _masked_shapes(q, k, v, window)
    ops.expect(o, q.dtype, 3, "o")
    ops.expect(do, q.dtype, 3, "do")
    ops.expect(lse, torch.float32, 2, "lse")
    ops.same_device(("q", q), ("o", o), ("do", do), ("lse", lse))
    bh, sq, d = q.shape
    sk, dv = k.shape[1], v.shape[2]
    kvl = _kv_limit(sk, kv_len)
    if (o.shape != (bh, sq, dv) or do.shape != o.shape
            or lse.shape != (bh, sq)):
        raise ValueError(f"o and do of (BH, Sq, Dv) = {(bh, sq, dv)} and lse "
                         f"of (BH, Sq) expected; got {tuple(o.shape)}, "
                         f"{tuple(do.shape)}, {tuple(lse.shape)}")
    dq, dk, dvv = (torch.empty_like(q), torch.empty_like(k),
                   torch.empty_like(v))
    if q.numel() == 0 or v.numel() == 0:
        return dq.zero_(), dk.zero_(), dvv.zero_()
    # Delta (bh, sq), then the float16 tensor-core build's dS stats (bh, 2)
    delta = torch.empty(bh * sq + 2 * bh, dtype=torch.float32,
                        device=q.device)
    a, b = keyless_rows(sq, sk, causal, window, q_offset, kvl)
    keyless = a > 0 or b < sq
    path = route or bwd_route(q.dtype, d, dv)
    if path == "wgmma" and bwd_route(q.dtype, d, dv) != "wgmma":
        raise ValueError(f"the wgmma backward takes bf16 and float16 with D "
                         f"and Dv <= {bwd_constants()['kSplitD']}; got "
                         f"{q.dtype}, D {d}, Dv {dv}")
    if path != "wgmma":
        path = _cuda_cores(d, dv)
    kl = None
    if keyless:  # the dV of the queries without a key, added by the kernel
        kl = torch.empty((bh, dv), dtype=torch.float32, device=q.device)
        _keyless(do, kl, None, sk, a, b, p_dtype, k_chunk, False)
    entry = (wgmma_entry("bwd", q.dtype, d, dv) if path == "wgmma"
             else BWD_KERNELS[path][0])
    with torch.cuda.device(q.device):
        rc = getattr(library(), entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dvv.data_ptr(), delta.data_ptr(),
            0 if kl is None else kl.data_ptr(), bh, sq, sk, d, dv,
            int(bool(causal)), q_offset, window, kvl, 1.0 / (d ** 0.5),
            int(p_dtype is not None), code,
            torch.cuda.current_stream().cuda_stream)
    ops.check_launch("flash_attention_bwd", rc, path)
    return dq, dk, dvv


class _FlashAttention(torch.autograd.Function):
    """K7 with its backward: on CUDA the forward kernel with ``lse`` and the
    backward kernel, on the CPU their plain versions.  ``kv_len`` is the
    key limit already clipped to ``[0, Sk]`` (an int)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, kv_len, p_dtype,
                k_chunk):
        if ops.on_plain_device(q, k, v):
            out, lse = flash_attention_masked_plain(
                q, k, v, causal, window, q_offset, kv_len, with_lse=True,
                p_dtype=p_dtype, k_chunk=k_chunk)
        else:
            out, lse = _launch(q, k, v, causal, window, q_offset, kv_len,
                               True, p_dtype, k_chunk)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = (causal, window, q_offset, kv_len, p_dtype, k_chunk)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        bwd = (flash_attention_masked_bwd_plain if ops.on_plain_device(q)
               else _launch_bwd)
        dq, dk, dv = bwd(q, k, v, out, lse, do.contiguous(), *ctx.mask)
        return dq, dk, dv, None, None, None, None, None, None


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _flash_attention_cuda(q, k, v, causal: bool = True, q_blk: int = 128,
                          k_blk: int = 128):
    _blocks(q, k, v, q_blk, k_blk)
    return _launch(q, k, v, causal, 0, 0, q.shape[1])


def _flash_attention_grad(q, k, v, causal: bool = True, q_blk: int = 128,
                          k_blk: int = 128):
    _blocks(q, k, v, q_blk, k_blk)
    return _FlashAttention.apply(q, k, v, causal, 0, 0, q.shape[1], None,
                                 1024)


def flash_attention_fused(q, k, v, causal: bool = True, q_blk: int = 128,
                          k_blk: int = 128):
    """Flash attention on ``(BH, S, D)`` q and k and ``(BH, S, Dv)`` v: the
    plain version on the CPU, the route's kernel on CUDA (q, k and v
    float32, bfloat16 or float16 of one dtype, any D and Dv).  ``q_blk``
    and ``k_blk`` keep the reference's divisibility contract; the kernels'
    own tiles are their choice.  Under autograd both devices go through
    ``_FlashAttention`` (forward with ``lse``, then the backward)."""
    if _needs_grad(q, k, v):
        return _flash_attention_grad(q, k, v, causal, q_blk, k_blk)
    return ops.dispatch(flash_attention_fused_plain, _flash_attention_cuda,
                        q, k, v, causal, q_blk, k_blk)


def _flash_attention_masked_cuda(q, k, v, causal: bool = True,
                                 window: int = 0, q_offset: int = 0,
                                 kv_len=None, p_dtype=None,
                                 k_chunk: int = 1024):
    _masked_shapes(q, k, v, window)
    return _launch(q, k, v, causal, window, q_offset,
                   _kv_limit(k.shape[1], kv_len), False, p_dtype, k_chunk)


def flash_attention_masked(q, k, v, causal: bool = True, window: int = 0,
                           q_offset: int = 0, kv_len=None, p_dtype=None,
                           k_chunk: int = 1024):
    """Flash attention on ``(BH, Sq, D)`` q, ``(BH, Sk, D)`` k and ``(BH,
    Sk, Dv)`` v under the chunked attention's masks (the module's
    docstring): the plain version on the CPU, the route's kernel on CUDA.
    ``kv_len`` (an int or a 0-d tensor, read once on the host) limits the
    keys; ``p_dtype`` (None or ``torch.bfloat16``) rounds P and V before
    P.V; the rows of queries without a key take the reference's value for
    its key chunk ``k_chunk``.  Under autograd both devices go through
    ``_FlashAttention``."""
    if _needs_grad(q, k, v):
        _masked_shapes(q, k, v, window)
        return _FlashAttention.apply(q, k, v, causal, window, q_offset,
                                     _kv_limit(k.shape[1], kv_len), p_dtype,
                                     k_chunk)
    return ops.dispatch(flash_attention_masked_plain,
                        _flash_attention_masked_cuda, q, k, v, causal,
                        window, q_offset, kv_len, p_dtype, k_chunk)
