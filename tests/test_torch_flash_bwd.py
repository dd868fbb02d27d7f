"""K7's backward against the JAX package, on the CPU.

* The plain forward's row log-sum-exp (``flash_attention_masked_plain(...,
  with_lse=True)``) against a float64 log-sum-exp of the same scores:
  within 1e-5 absolute (float32 sums of O(1) terms).
* ``flash_attention_masked_bwd_plain`` (what the CPU runs for K7's gradient,
  and what ``chip_smoke.py`` holds the CUDA kernel to) against
  ``jax.grad`` of the reference's chunked ``flash_attention``
  (``repro.models.attention``), with the same output gradient ``do``, in
  float32: causal and not, a window, a query offset, a key limit,
  Sq != Sk, a ragged S, D 64, D 96 and MLA's 192 / 128.  The two sum in
  another order and the port scales by ``1/sqrt(D)`` rounded once from
  double, the reference by ``1/sqrt(float32(D))``: one float32 ulp apart
  at D = 96 (a relative 6e-8 on every score; asserted below), equal at 64
  and 192.  Tolerance: within 1e-4 of the largest |gradient| of each of
  dq, dk and dv.
* The autograd ``Function`` (``ops.flash_attention_masked`` on tensors that
  need a gradient) against autograd through the plain forward's own
  operations: within 1e-5 of the largest |gradient| (two float32
  evaluations of the same equations).
* The CUDA kernels' loop bounds (``csrc/flash_attention_bwd.cu``, 64-key
  and 64-query blocks; ``csrc/flash_bwd_wgmma.cuh``, 128-key and
  128-query blocks of two 64-row warpgroups over 64-row tiles, or, in MLA's
  build, 32-query tiles in the dK/dV pass, or, in the split build, 32-row
  tiles in both passes, each warpgroup skipping the tiles none of its
  pairs is valid in): the dK/dV pass visits, for each key block, the
  query tiles from the causal diagonal to the window's far edge; the dQ
  pass the key tiles the forward visits.  Emulated here over a grid of
  masks, every valid (query, key) pair must fall in a visited tile of both
  passes, and every tile the tensor-core kernel leaves unmasked must hold
  valid pairs only.
* The tensor-core kernel's arithmetic (16-bit products exact in float32,
  ``exp2`` with the scale folded with log2(e), P and dS split into the
  source's ``kTerms`` bf16 or ``kTermsF16`` f16 terms, f16's P as
  ``p * 2**15``, tiles summed in the passes' order of the build
  ``bwd_widths`` names; under ``p_dtype`` V rounded to bf16 and P one
  bf16-rounded term in dV; the keyless queries' dV added before dV
  rounds), emulated on the CPU and held to ``chip_smoke.py``'s backward
  gate against the plain backward: ``FLASH_BWD_F32`` of the call's
  largest |gradient| plus one step of each value's type (``LOWP_STEP``),
  and under ``p_dtype`` dV to ``P_DTYPE_MEAN``.  One term of either type
  misses its gate; two meet it; without the rounding dV misses
  ``P_DTYPE_MEAN``.
* ``bwd_route``: bf16 and float16 up to 256 columns (the source's
  ``kSplitD``) on the tensor cores, with or without ``p_dtype`` and keyless
  queries; float32 and wider heads on the CUDA cores, each an entry point
  the build binds; ``bwd_widths`` names each call's build.
The CUDA kernels themselves are held against the plain version on the card
by ``chip_smoke.py`` (``train_phase``).
"""
import importlib.util
import itertools
import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as ref_attn
from repro_torch.kernels import flash_attention as k7
from repro_torch.kernels import ops

GRAD_TOL = 1e-4     # of the largest |gradient|, port vs reference
FUNCTION_TOL = 1e-5  # of the largest |gradient|, Function vs autograd
LSE_TOL = 1e-5

# name: (sq, sk, d, dv, causal, window, q_offset, kv_len)
CASES = {
    "causal": (64, 64, 64, 64, True, 0, 0, None),
    "unmasked": (64, 64, 64, 64, False, 0, 0, None),
    "window": (80, 80, 64, 64, True, 16, 0, None),
    "q_offset": (40, 64, 64, 64, True, 0, 24, None),
    "key_limit": (64, 64, 64, 64, False, 0, 0, 50),
    "sq_ne_sk": (24, 72, 64, 64, False, 0, 0, None),
    "ragged": (70, 70, 64, 64, True, 0, 0, None),
    "d96": (64, 64, 96, 96, True, 0, 0, None),
    "mla_192_128": (48, 48, 192, 128, True, 0, 0, None),
}
HEADS = 2


def _inputs(case, seed=0):
    sq, sk, d, dv = CASES[case][:4]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((1, sq, HEADS, d)).astype(np.float32)
    k = rng.standard_normal((1, sk, HEADS, d)).astype(np.float32)
    v = rng.standard_normal((1, sk, HEADS, dv)).astype(np.float32)
    do = rng.standard_normal((1, sq, HEADS, dv)).astype(np.float32)
    return q, k, v, do


def _heads_first(x):
    """(1, S, H, D) numpy -> (H, S, D) torch."""
    return torch.from_numpy(np.ascontiguousarray(x[0].transpose(1, 0, 2)))


def _ref_grads(case, q, k, v, do):
    _, _, _, _, causal, window, q_offset, kv_len = CASES[case]
    kvl = None if kv_len is None else jnp.asarray(kv_len, jnp.int32)

    def f(q, k, v):
        out = ref_attn.flash_attention(q, k, v, causal=causal, window=window,
                                       q_offset=q_offset, q_chunk=32,
                                       k_chunk=64, kv_valid_len=kvl)
        return jnp.sum(out * do)

    grads = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v))
    return [_heads_first(np.asarray(g)) for g in grads]


def _mask_args(case):
    _, _, _, _, causal, window, q_offset, kv_len = CASES[case]
    return causal, window, q_offset, kv_len


def _close(got, want, tol, what):
    err = float((got.float() - want.float()).abs().max())
    bound = tol * float(want.float().abs().max())
    assert err <= bound, f"{what}: max |error| {err} > {bound}"


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_backward_matches_jax_grad(case):
    q, k, v, do = _inputs(case)
    tq, tk, tv, tdo = map(_heads_first, (q, k, v, do))
    args = _mask_args(case)
    out, lse = k7.flash_attention_masked_plain(tq, tk, tv, *args,
                                               with_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == tq.shape[:2]
    # lse against float64
    causal, window, q_offset, kv_len = args
    sq, sk, d = tq.shape[1], tk.shape[1], tq.shape[2]
    s64 = np.einsum("hqd,hkd->hqk", tq.double().numpy(),
                    tk.double().numpy()) / np.sqrt(d)
    qpos = q_offset + np.arange(sq)[:, None]
    kpos = np.arange(sk)[None, :]
    ok = kpos < (sk if kv_len is None else kv_len)
    if causal:
        ok = ok & (kpos <= qpos)
    if window:
        ok = ok & (kpos > qpos - window)
    s64 = np.where(ok, s64, -np.inf)
    want_lse = np.log(np.exp(s64 - s64.max(-1, keepdims=True)).sum(-1)) \
        + s64.max(-1)
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=0, atol=LSE_TOL)

    got = k7.flash_attention_masked_bwd_plain(tq, tk, tv, out, lse, tdo,
                                              *args)
    want = _ref_grads(case, q, k, v, do)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        _close(g, w, GRAD_TOL, f"{case} {name}")


def test_scale_is_one_ulp_off_the_reference_at_d96():
    """The port's scale, 1/sqrt(D) rounded once from double, and the
    reference model's 1/sqrt(float32(D)): one float32 ulp apart at D = 96,
    equal at 64 and 192."""
    def ulps(d):
        port = np.float32(1.0 / (d ** 0.5))
        ref = np.float32(1.0) / np.sqrt(np.float32(d))
        return abs(int(port.view(np.int32)) - int(ref.view(np.int32)))

    assert ulps(96) == 1
    assert ulps(64) == 0 and ulps(192) == 0


@pytest.mark.parametrize("case", ["causal", "window", "q_offset", "key_limit",
                                  "sq_ne_sk", "mla_192_128"])
def test_function_gradients_equal_autograd_through_the_plain_forward(case):
    q, k, v, do = _inputs(case, seed=1)
    args = _mask_args(case)
    leaves = [_heads_first(x).requires_grad_() for x in (q, k, v)]
    before = ops.launch_counts()
    out = ops.flash_attention_masked(*leaves, *args)
    got = torch.autograd.grad(out, leaves, _heads_first(do))
    assert ops.launch_counts() == before  # the plain versions on the CPU
    out2 = k7.flash_attention_masked_plain(*leaves, *args)
    want = torch.autograd.grad(out2, leaves, _heads_first(do))
    torch.testing.assert_close(out, out2, rtol=0, atol=0)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _close(g, w, FUNCTION_TOL, f"{case} {name}")


def test_fused_entry_is_differentiable():
    """``ops.flash_attention_fused`` takes the same Function."""
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 64, 16))
                                .astype(np.float32)).requires_grad_()
               for _ in range(3))
    out = ops.flash_attention_fused(q, k, v, True, 32, 32)
    got = torch.autograd.grad(out.sum(), (q, k, v))
    want = torch.autograd.grad(
        k7.flash_attention_fused_plain(q, k, v, True, 32, 32).sum(), (q, k, v))
    for g, w in zip(got, want):
        _close(g, w, FUNCTION_TOL, "fused")


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CHIP = _chip_smoke()
BWD = k7.bwd_constants()  # kTerms, kRows, kBT, kMaxD, ... of the wgmma kernel
# (block rows, the dK/dV pass's query tile, the dQ pass's key tile,
# warpgroup rows) of each kernel: key blocks in the dK/dV pass, query blocks
# in the dQ pass; warpgroup rows None: the block never skips a tile
WG_ROWS = BWD["kRows"] // BWD["kWG"]
TILINGS = {"cuda_cores": (64, 64, 64, None),
           "wgmma": (BWD["kRows"], BWD["kBT"], BWD["kBT"], WG_ROWS),
           "wgmma_mla": (BWD["kRows"], BWD["kWideBT"], BWD["kBT"], WG_ROWS),
           "wgmma_split": (BWD["kRows"], BWD["kSplitBT"], BWD["kSplitBT"],
                           WG_ROWS)}


def _bwd_tiles_cover(sq, sk, causal, window, q_offset, kv_len, tiling):
    """The kernel's loop bounds, as in its source, and whether they cover
    every valid pair; with warpgroups, also whether every tile they leave
    unmasked holds valid pairs only."""
    rows, tile, k_tile, wg_rows = TILINGS[tiling]
    kvl = min(kv_len, sk)
    qi = np.arange(sq)[:, None]
    kj = np.arange(sk)[None, :]
    p = qi + q_offset
    valid = (kj < kvl) & (kj <= p if causal else qi >= 0)
    if window > 0:
        valid = valid & (kj > p - window)

    def key_lo(p):
        return p - window + 1 if window > 0 else 0

    def key_hi(p):
        return min(kvl, p + 1) if causal else kvl

    def unmasked_ok(q0, q1, k0, k1):
        return bool(np.all(valid[q0:q1, k0:k1])) and q1 <= sq and k1 <= sk

    wgs = [(0, rows)] if wg_rows is None else \
        [(w, w + wg_rows) for w in range(0, rows, wg_rows)]
    seen_kv = np.zeros((sq, sk), bool)
    for k0 in range(0, sk, rows):  # dkdv_kernel
        k1 = min(k0 + rows, kvl)
        i_lo = max(0, k0 - q_offset) if causal else 0
        i_hi = min(sq, k1 - 1 + window - q_offset) if window > 0 else sq
        if k0 >= kvl:
            i_hi = i_lo
        t_lo = i_lo // tile
        t_hi = (i_hi + tile - 1) // tile if i_hi > i_lo else t_lo
        for q0 in range(t_lo * tile, t_hi * tile, tile):
            for w0, w1 in wgs:
                kw0, kw1 = k0 + w0, k0 + w1
                if wg_rows is not None:
                    q_last = min(q0 + tile, sq) - 1
                    if not (kw0 < key_hi(q_last + q_offset)
                            and kw1 > key_lo(q0 + q_offset)):
                        continue
                    edge = (q0 + tile > sq
                            or kw0 < key_lo(q0 + tile - 1 + q_offset)
                            or kw1 > key_hi(q0 + q_offset))
                    if not edge and not unmasked_ok(q0, q0 + tile, kw0, kw1):
                        return False
                seen_kv[q0:q0 + tile, kw0:kw1] = True
    seen_q = np.zeros((sq, sk), bool)
    for q0 in range(0, sq, rows):  # dq_kernel
        last_q = min(q0 + rows, sq) - 1
        hi = min(kvl, last_q + q_offset + 1) if causal else kvl
        lo = max(0, q0 + q_offset - window + 1) if window > 0 else 0
        t_lo = lo // k_tile
        t_hi = (hi + k_tile - 1) // k_tile if hi > lo else t_lo
        for k0 in range(t_lo * k_tile, t_hi * k_tile, k_tile):
            for w0, w1 in wgs:
                if wg_rows is not None:
                    p0 = q0 + w0 + q_offset
                    if not (k0 + k_tile > key_lo(p0)
                            and k0 < key_hi(p0 + wg_rows - 1)):
                        continue
                    edge = (k0 < key_lo(p0 + wg_rows - 1)
                            or k0 + k_tile > key_hi(p0))
                    # rows past Sq are not stored: only rows below it count
                    if not edge and not unmasked_ok(
                            q0 + w0, min(q0 + w1, sq), k0, k0 + k_tile):
                        return False
                seen_q[q0 + w0:q0 + w1, k0:k0 + k_tile] = True
    return bool(np.all(seen_kv[valid])) and bool(np.all(seen_q[valid]))


@pytest.mark.parametrize("tiling", sorted(TILINGS))
def test_kernel_tile_ranges_cover_every_valid_pair(tiling):
    for sq, sk, causal, window, q_offset, kv_len in itertools.product(
            (1, 63, 64, 130), (1, 64, 129, 200), (True, False), (0, 1, 17, 64),
            (0, 5, 62, 70), (1, 60, 63, 10**6)):
        assert _bwd_tiles_cover(sq, sk, causal, window, q_offset, kv_len,
                                tiling), (
            sq, sk, causal, window, q_offset, kv_len)


def _split(x, terms, kind="bf16", scale=1.0, bf16=False):
    """x as ``terms`` terms of the kernel's type (``kind``), each the
    rounding of what is left, in float32: f16 terms of ``x * scale``,
    scaled back (a power of two); ``bf16``: x rounded to bf16 first."""
    out = []
    x = x * scale
    if bf16:
        x = x.bfloat16().float()
    for _ in range(terms):
        t = (x.half() if kind == "f16" else x.bfloat16()).float()
        out.append(t / scale)
        x = x - t
    return out


def ds_scale(v, do):
    """float16's dS scale (``flash_bwd_wgmma.cuh``'s ``ds_scale``), a
    (BH, 1, 1) tensor of powers of two: 2^e with 2^e * 2 max_i |dO_i|
    max_j |V_j| below 2^kF16DsLog2, 1 where that bound is 0."""
    bound = 2 * (do.float() ** 2).sum(-1).amax(-1).sqrt() \
        * (v.float() ** 2).sum(-1).amax(-1).sqrt()
    e = (BWD["kF16DsLog2"] - torch.frexp(bound).exponent).clamp(-100, 100)
    sig = torch.where((bound > 0) & torch.isfinite(bound),
                      torch.pow(2.0, e.float()), 1.0)
    return sig[:, None, None]


def emulate_bwd_wgmma(q, k, v, o, lse, do, causal, window, q_offset, kv_len,
                      terms, p_dtype=None, k_chunk=1024, scale_ds=True):
    """The tensor-core backward's arithmetic on the CPU, from bf16 or
    float16 q, k, v, o, do and the forward's float32 lse: scores and dP
    from 16-bit products in float32; P = 2^(S * c - lse * log2 e), c the
    scale and log2(e) in one float32; dS = P (dP - Delta); P and dS split
    into ``terms`` terms of the operands' type (f16's P as p * 2**15, its
    dS as dS * ``ds_scale`` unless ``scale_ds`` is False), each
    multiplied into float32 sums over the passes' tiles in ascending order
    (the dK/dV pass's query tile and the dQ pass's key tile of the build
    ``bwd_widths`` names); under ``p_dtype`` V rounded to bf16 (float16's
    kernel rounds its V tiles to f16(bf16(v) / 2) in shared memory and
    doubles dP back: the same values) and P in dV one term, rounded to
    bf16; the keyless queries' float32 dV
    added before dV rounds; dK and dQ scaled at the end, every gradient
    rounded once to the operands' type."""
    kind = "f16" if q.dtype == torch.float16 else "bf16"
    pscale = 2.0 ** BWD["kF16PScaleLog2"] if kind == "f16" else 1.0
    sq, d, sk = q.shape[1], q.shape[2], k.shape[1]
    dv_w = v.shape[2]
    bt_kv = k7.bwd_widths(d, dv_w)[2]
    bt_q = BWD["kSplitBT"] if k7.bwd_widths(d, dv_w)[0] == BWD["kSplitD"] \
        else BWD["kBT"]
    kvl = sk if kv_len is None else min(kv_len, sk)
    scale = float(np.float32(1.0 / d ** 0.5))
    c = float(np.float32(np.float64(scale) * math.log2(math.e)))
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    if p_dtype is not None:
        vf = (v.bfloat16().float() * 0.5).to(q.dtype).float() * 2.0
    delta = (dof * o.float()).sum(-1, keepdim=True)
    x = torch.matmul(qf, kf.transpose(1, 2)) * c \
        - lse[..., None] * np.float32(math.log2(math.e))
    ok = k7._valid(sq, 0, sk, causal, window, q_offset, q.device) \
        & (torch.arange(sk)[None, :] < kvl)
    p = torch.where(ok, torch.exp2(x), 0.0)
    ds = p * (torch.matmul(dof, vf.transpose(1, 2)) - delta)
    dq, dk, dv = torch.zeros_like(qf), torch.zeros_like(kf), \
        torch.zeros_like(vf)
    p_terms = 1 if p_dtype is not None else terms
    dscale = ds_scale(v, do) if kind == "f16" and scale_ds else 1.0
    for t0 in range(0, sq, bt_kv):
        sl = slice(t0, t0 + bt_kv)
        for tp in _split(p[:, sl], p_terms, kind, pscale,
                         bf16=p_dtype is not None):
            dv += torch.matmul(tp.transpose(1, 2), dof[:, sl])
        for td in _split(ds[:, sl], terms, kind, dscale):
            dk += torch.matmul(td.transpose(1, 2), qf[:, sl])
    for t0 in range(0, sk, bt_q):
        sl = slice(t0, t0 + bt_q)
        for td in _split(ds[:, :, sl], terms, kind, dscale):
            dq += torch.matmul(td, kf[:, sl])
    a, b = k7.keyless_rows(sq, sk, causal, window, q_offset, kv_len)
    if a > 0 or b < sq:
        g = dof[:, :a].sum(1, keepdim=True) + dof[:, b:].sum(1, keepdim=True)
        dv = dv + g / k7.keyless_den(sk, k_chunk)
    return ((dq * scale).to(q.dtype), (dk * scale).to(q.dtype),
            dv.to(q.dtype))


def bwd_gate_misses(got, want) -> int:
    """Values beyond chip_smoke.py's backward gate of their type (one
    rounding step of each value, ``LOWP_STEP``, beyond the float32 gate)."""
    scale = max(float(w.double().abs().max()) for w in want)
    misses = 0
    for g, w in zip(got, want):
        diff = (g.double() - w.double()).abs()
        gate = CHIP.FLASH_BWD_F32 * scale \
            + CHIP.LOWP_STEP[str(w.dtype)] * w.double().abs()
        misses += int((diff > gate).sum())
    return misses


def _bf16_case(bh, sq, sk, d, dv, causal, window, q_offset, kv_len, seed=0,
               dtype=torch.bfloat16, p_dtype=None, scales=(1, 1, 1, 1)):
    """16-bit operands (standard normal times ``scales``, for q, k, v and
    do), the plain forward's o and lse, the plain backward."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy((rng.standard_normal(shape) * sc)
                                    .astype(np.float32)).to(dtype)
                   for shape, sc in zip(((bh, sq, d), (bh, sk, d),
                                         (bh, sk, dv), (bh, sq, dv)),
                                        scales))
    args = (causal, window, q_offset, kv_len)
    o, lse = k7.flash_attention_masked_plain(q, k, v, *args, with_lse=True,
                                             p_dtype=p_dtype)
    want = k7.flash_attention_masked_bwd_plain(q, k, v, o, lse, do, *args,
                                               p_dtype=p_dtype)
    return (q, k, v, o, lse, do, *args), want


# (bh, sq, sk, d, dv, causal, window, q_offset, kv_len) on the tensor-core
# route: granite's head at small S across 64 heads, Phi-3's, a window, a
# query offset with Sq < Sk, a key limit, cross-attention's unequal lengths,
# and MLA's qk 192 / v 128 (causal, and with a key limit and Sq != Sk)
BWD_WGMMA_CASES = {
    "d64_causal_64_heads": (64, 256, 256, 64, 64, True, 0, 0, None),
    "d96_causal": (8, 192, 192, 96, 96, True, 0, 0, None),
    "window_64": (8, 256, 256, 64, 64, True, 64, 0, None),
    "window_1": (8, 256, 256, 64, 64, True, 1, 0, None),
    "q_offset": (8, 64, 200, 64, 64, True, 0, 136, None),
    "key_limit_d96": (8, 200, 200, 96, 96, False, 0, 0, 150),
    "sq_ne_sk": (8, 100, 300, 64, 64, False, 0, 0, None),
    "d128_window": (4, 200, 200, 128, 128, True, 100, 0, None),
    "mla_192_128": (8, 256, 256, 192, 128, True, 0, 0, None),
    "mla_key_limit_sq_ne_sk": (4, 100, 230, 192, 128, False, 0, 0, 170),
    # Dv > D (the narrow build qk 64 / v 128, and a square one), the split
    # build (D 160, D 256 with a window, unequal widths under a key limit)
    # and queries without a key (their dV added before dV rounds)
    "dv_past_d_64_128": (8, 200, 200, 64, 128, True, 0, 0, None),
    "dv_past_d_8_16": (8, 100, 100, 8, 16, True, 0, 0, None),
    "split_160": (4, 130, 130, 160, 160, True, 0, 0, None),
    "split_256_window": (4, 200, 200, 256, 256, True, 64, 0, None),
    "split_key_limit_sq_ne_sk": (2, 100, 230, 200, 256, False, 0, 0, 170),
    "keyless_first_queries": (8, 96, 96, 64, 64, True, 0, -3, None),
}


@pytest.mark.parametrize("case", sorted(BWD_WGMMA_CASES))
def test_bwd_wgmma_arithmetic_meets_the_bf16_gate(case):
    shape = BWD_WGMMA_CASES[case]
    assert k7.bwd_route(torch.bfloat16, shape[3], shape[4]) == "wgmma"
    args, want = _bf16_case(*shape)
    got = emulate_bwd_wgmma(*args, BWD["kTerms"])
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
    assert bwd_gate_misses(got, want) == 0


# the float16 cases: granite's head across 64 heads, Phi-3's, a window of
# one key, MLA's widths, the split build, Dv > D, keyless queries
BWD_F16_CASES = ("d64_causal_64_heads", "d96_causal", "window_1",
                 "mla_192_128", "split_256_window", "dv_past_d_64_128",
                 "keyless_first_queries")


@pytest.mark.parametrize("case", BWD_F16_CASES)
def test_bwd_wgmma_arithmetic_meets_the_f16_gate(case):
    """float16 on the tensor cores: f16 products, P (as p * 2**15) and dS
    in ``kTermsF16`` f16 terms, against the plain backward under the f16
    gate."""
    shape = BWD_WGMMA_CASES[case]
    assert k7.bwd_route(torch.float16, shape[3], shape[4]) == "wgmma"
    args, want = _bf16_case(*shape, dtype=torch.float16)
    got = emulate_bwd_wgmma(*args, BWD["kTermsF16"])
    for g, w in zip(got, want):
        assert g.dtype == torch.float16 and g.shape == w.shape
    assert bwd_gate_misses(got, want) == 0


# float16 cases whose dS leaves f16's normal range, (scales of q, k, v, do)
# on the causal (8, 128, 128, 64) call: a large V against small scores
# gives |dS| up to ~88,000 > 65,504 with dQ, dK and dV in range; a small
# dO and V every |dS| below 2^-14 (~2.5e-5 at most), where an unscaled f16
# term is subnormal, with K large (and Q small, for scores of order 1) so
# that dQ, ~1e-2, is the largest gradient and far from f16's subnormals
DS_RANGE = {"large_ds": (2 ** -3, 2 ** -5, 2 ** 12, 4.0),
            "small_ds": (2 ** -10, 2 ** 10, 2 ** -6, 2 ** -12)}
DS_SHAPE = (8, 128, 128, 64, 64, True, 0, 0, None)


def _ds(args):
    """The plain backward's dS = P (dP - Delta), float32."""
    q, k, v, o, lse, do, causal, window, q_offset, kv_len = args
    sq, sk, d = q.shape[1], k.shape[1], q.shape[2]
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) / math.sqrt(d)
    ok = k7._valid(sq, 0, sk, causal, window, q_offset, q.device)
    p = torch.where(ok, torch.exp(s - lse[..., None]), 0.0)
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    return p * (torch.matmul(do.float(), v.float().transpose(1, 2)) - delta)


@pytest.mark.parametrize("case", sorted(DS_RANGE))
def test_f16_plain_backward_past_ds_range_matches_jax_grad(case):
    """The float16 calls whose dS passes 65,504 or sits below 2^-14: the
    plain backward against ``jax.grad`` of the reference's attention on the
    same values in float32.  On float32 operands within GRAD_TOL of each
    gradient's largest |value|; on the float16 ones (float32 sums, each
    gradient rounded once to f16, and Delta = sum(dO O) from the forward's
    f16 O) within one f16 step (2^-10) of the largest |value| and of each
    value, plus half f16's smallest step (2^-25, where a gradient rounds to
    a subnormal or to 0), every gradient finite."""
    args, want = _bf16_case(*DS_SHAPE, dtype=torch.float16,
                            scales=DS_RANGE[case])
    ds = _ds(args).abs()
    if case == "large_ds":
        assert float(ds.max()) > 65504
    else:
        assert 0 < float(ds.max()) < 2 ** -14
    q, k, v, _, _, do = args[:6]
    mask = args[6:]

    def to_ref(x):
        return jnp.asarray(x.float().numpy().transpose(1, 0, 2)[None])

    def f(q_, k_, v_):
        out = ref_attn.flash_attention(q_, k_, v_, causal=mask[0],
                                       q_chunk=32, k_chunk=64)
        return jnp.sum(out * to_ref(do))

    ref = [_heads_first(np.asarray(w)) for w in
           jax.grad(f, argnums=(0, 1, 2))(*(to_ref(x) for x in (q, k, v)))]
    f32 = [x.float() for x in (q, k, v, do)]
    o32, lse32 = k7.flash_attention_masked_plain(*f32[:3], *mask,
                                                 with_lse=True)
    got32 = k7.flash_attention_masked_bwd_plain(*f32[:3], o32, lse32, f32[3],
                                                *mask)
    for name, g, g16, w in zip(("dq", "dk", "dv"), got32, want, ref):
        _close(g, w, GRAD_TOL, f"{case} {name} float32")
        assert g16.dtype == torch.float16 and bool(torch.isfinite(g16).all())
        err = (g16.double() - w.double()).abs()
        gate = 2 ** -10 * (float(w.abs().max()) + w.double().abs()) \
            + 2 ** -25
        assert bool((err <= gate).all()), \
            f"{case} {name} float16: max |error| {float(err.max())}"


@pytest.mark.parametrize("scaled", [True, False])
@pytest.mark.parametrize("case", sorted(DS_RANGE))
def test_f16_ds_scale_meets_the_f16_gate_past_ds_range(case, scaled):
    """The float16 tensor-core arithmetic on those calls: with dS carried
    at ``ds_scale``'s power of two, every gradient is finite and within the
    f16 gate of the plain backward; carried as it is (the build before the
    scale), a large dS overflows f16 (dQ and dK not finite) and a small
    one misses the gate."""
    args, want = _bf16_case(*DS_SHAPE, dtype=torch.float16,
                            scales=DS_RANGE[case])
    got = emulate_bwd_wgmma(*args, BWD["kTermsF16"], scale_ds=scaled)
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    if scaled:
        assert finite and bwd_gate_misses(got, want) == 0
    else:
        assert not finite or bwd_gate_misses(got, want) > 0


@pytest.mark.parametrize("terms,misses", [(1, True), (2, False)])
def test_bwd_term_count_against_the_f16_gate(terms, misses):
    """One f16 term of P and dS (2^-11 of each) misses the f16 gate across
    64 causal heads; two (2^-22) meet it."""
    args, want = _bf16_case(*BWD_WGMMA_CASES["d64_causal_64_heads"],
                            dtype=torch.float16)
    got = emulate_bwd_wgmma(*args, terms)
    assert (bwd_gate_misses(got, want) > 0) == misses


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case", ["d64_causal_64_heads", "split_256_window"])
def test_bwd_p_dtype_arithmetic_meets_the_p_dtype_gate(dtype, case):
    """``p_dtype`` on the tensor cores: V rounded to bf16 in dP, P in dV
    one term rounded to bf16, dS keeping its terms.  dV within
    ``chip_smoke.py``'s ``P_DTYPE_MEAN`` of the plain backward under
    ``p_dtype`` (sum |error| over sum |value|), dQ and dK within the
    backward's own gate; the same build without the rounding misses
    ``P_DTYPE_MEAN`` on dV."""
    pdt = torch.bfloat16
    args, want = _bf16_case(*BWD_WGMMA_CASES[case], dtype=dtype, p_dtype=pdt)
    terms = BWD["kTermsF16" if dtype == torch.float16 else "kTerms"]
    got = emulate_bwd_wgmma(*args, terms, p_dtype=pdt)
    assert CHIP.error_share(got[2], want[2]) <= CHIP.P_DTYPE_MEAN
    assert bwd_gate_misses(got[:2], want[:2]) == 0
    full = emulate_bwd_wgmma(*args, terms)
    assert CHIP.error_share(full[2], want[2]) > CHIP.P_DTYPE_MEAN


@pytest.mark.parametrize("terms,misses", [(1, True), (2, False)])
def test_bwd_term_count_against_the_bf16_gate(terms, misses):
    """One bf16 term of P and dS (2^-9 of each) misses the gate across 64
    causal heads; two (2^-18) meet it, as the kernel's three do."""
    args, want = _bf16_case(*BWD_WGMMA_CASES["d64_causal_64_heads"])
    got = emulate_bwd_wgmma(*args, terms)
    assert (bwd_gate_misses(got, want) > 0) == misses


def test_bwd_routes_by_dtype_and_width_to_built_entry_points():
    """bf16 and float16 with D and Dv up to kSplitD (256) on the tensor
    cores (``p_dtype`` and keyless queries choose no route); float32, and
    16-bit heads past 256, on the CUDA cores; each route names C entry
    points the build binds.  (Before the split build, bf16 heads of 129 to
    256 columns other than MLA's, float16, ``p_dtype``, keyless queries and
    Dv > D took the CUDA cores.)"""
    from repro_torch.kernels._build import SIGNATURES

    assert BWD["kMaxD"] == 128 and BWD["kSplitD"] == 256
    assert (BWD["kWideD"], BWD["kWideDV"], BWD["kWideBT"]) == (192, 128, 32)
    for d in (7, 32, 64, 96, 128):
        assert k7.bwd_route(torch.bfloat16, d, d) == "wgmma"
        assert k7.bwd_route(torch.float16, d, d) == "wgmma"
        assert k7.bwd_route(torch.float32, d, d) == "cuda_cores"
    assert k7.bwd_route(torch.bfloat16, 96, 80) == "wgmma"
    assert k7.bwd_route(torch.bfloat16, 192, 128) == "wgmma"
    assert k7.bwd_route(torch.float32, 192, 128) == "cuda_cores"
    for d, dv in ((129, 129), (160, 160), (192, 192), (64, 256), (256, 256)):
        assert k7.bwd_route(torch.bfloat16, d, dv) == "wgmma"
        assert k7.bwd_route(torch.float16, d, dv) == "wgmma"
    assert k7.bwd_route(torch.bfloat16, 257, 64) == "cuda_cores_slabs"
    assert k7.bwd_route(torch.float16, 64, 320) == "cuda_cores_slabs"
    assert set(k7.BWD_KERNELS) == {"wgmma", "cuda_cores", "cuda_cores_slabs"}
    assert all(name in SIGNATURES for names in k7.BWD_KERNELS.values()
               for name in names)


@pytest.mark.parametrize("d,dv,want", [
    (7, 7, (32, 32, 64)), (64, 64, (64, 64, 64)), (96, 80, (96, 96, 64)),
    (128, 128, (128, 128, 64)), (192, 128, (192, 128, 32)),
    (160, 128, (192, 128, 32)), (64, 128, (64, 128, 64)),
    (8, 16, (32, 32, 64)), (96, 128, (128, 128, 64)),
    (160, 160, (256, 256, 32)), (256, 256, (256, 256, 32)),
    (64, 256, (256, 256, 32))])
def test_bwd_widths_name_the_build_each_wgmma_call_launches(d, dv, want):
    """The template arguments (qk, value, dK/dV query tile) of the
    tensor-core build a call takes, as the sources' entry points switch:
    the square builds pad the wider width to a multiple of 32 with
    kBT-query tiles, qk 64 / v 128 has a build of its own, D 129..192 with
    Dv <= 128 takes MLA's, and every other head up to 256 the split
    build, whose entry point is the wide source's."""
    assert k7.bwd_route(torch.bfloat16, d, dv) == "wgmma"
    assert k7.bwd_widths(d, dv) == want
    entry = k7.wgmma_entry("bwd", torch.bfloat16, d, dv)
    assert entry.endswith("_wide") == (want[0] == BWD["kSplitD"])
