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
  and 64-query blocks; ``csrc/flash_attention_bwd_wgmma.cu``, 128-key and
  128-query blocks of two 64-row warpgroups over 64-row tiles, or, in MLA's
  build, 32-query tiles in the dK/dV pass, each warpgroup skipping the
  tiles none of its pairs is valid in): the dK/dV pass visits, for each
  key block, the query tiles from the causal diagonal to the window's far
  edge; the dQ pass the key tiles the forward visits.  Emulated here over
  a grid of masks, every valid (query, key) pair must fall in a visited
  tile of both passes, and every tile the tensor-core kernel leaves
  unmasked must hold valid pairs only.
* The tensor-core kernel's arithmetic (bf16 products exact in float32,
  ``exp2`` with the scale folded with log2(e), P and dS split into the
  source's ``kTerms`` bf16 terms, tiles summed in the passes' order, MLA's
  dK/dV pass over ``kWideBT``-query tiles), emulated on the CPU and held
  to ``chip_smoke.py``'s backward gate against the plain backward:
  ``FLASH_BWD_F32`` of the call's largest |gradient| plus
  ``FLASH_BWD_BF16_STEP`` of each value.  One term misses that gate; two
  meet it.
* ``bwd_route``: bf16 up to the source's ``kMaxD``, and MLA's qk 192 / v
  128, on the tensor cores; float32 and the other heads past 128 on the
  CUDA cores, each an entry point the build binds.
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
           "wgmma_mla": (BWD["kRows"], BWD["kWideBT"], BWD["kBT"], WG_ROWS)}


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


def _split(x, terms):
    """x as ``terms`` bf16 terms, each the rounding of what is left."""
    out = []
    for _ in range(terms):
        out.append(x.bfloat16().float())
        x = x - out[-1]
    return out


def emulate_bwd_wgmma(q, k, v, o, lse, do, causal, window, q_offset, kv_len,
                      terms):
    """The tensor-core backward's arithmetic on the CPU, from bf16 q, k, v,
    o, do and the forward's float32 lse: scores and dP from bf16 products in
    float32; P = 2^(S * c - lse * log2 e), c the scale and log2(e) in one
    float32; dS = P (dP - Delta); P and dS split into ``terms`` bf16 terms,
    each multiplied into float32 sums over the passes' tiles in ascending
    order (dK/dV over kBT-query tiles, kWideBT in MLA's build past kMaxD;
    dQ over kBT-key tiles); dK and dQ scaled at the end, every gradient
    rounded once to bf16."""
    bt = BWD["kBT"]
    sq, d, sk = q.shape[1], q.shape[2], k.shape[1]
    bt_kv = BWD["kWideBT"] if d > BWD["kMaxD"] else bt
    kvl = sk if kv_len is None else min(kv_len, sk)
    scale = float(np.float32(1.0 / d ** 0.5))
    c = float(np.float32(np.float64(scale) * math.log2(math.e)))
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    delta = (dof * o.float()).sum(-1, keepdim=True)
    x = torch.matmul(qf, kf.transpose(1, 2)) * c \
        - lse[..., None] * np.float32(math.log2(math.e))
    ok = k7._valid(sq, 0, sk, causal, window, q_offset, q.device) \
        & (torch.arange(sk)[None, :] < kvl)
    p = torch.where(ok, torch.exp2(x), 0.0)
    ds = p * (torch.matmul(dof, vf.transpose(1, 2)) - delta)
    dq, dk, dv = torch.zeros_like(qf), torch.zeros_like(kf), \
        torch.zeros_like(vf)
    for t0 in range(0, sq, bt_kv):
        sl = slice(t0, t0 + bt_kv)
        for tp, td in zip(_split(p[:, sl], terms), _split(ds[:, sl], terms)):
            dv += torch.matmul(tp.transpose(1, 2), dof[:, sl])
            dk += torch.matmul(td.transpose(1, 2), qf[:, sl])
    for t0 in range(0, sk, bt):
        sl = slice(t0, t0 + bt)
        for td in _split(ds[:, :, sl], terms):
            dq += torch.matmul(td, kf[:, sl])
    return ((dq * scale).bfloat16(), (dk * scale).bfloat16(),
            dv.bfloat16())


def bwd_gate_misses(got, want) -> int:
    """Values beyond chip_smoke.py's bf16 backward gate."""
    scale = max(float(w.double().abs().max()) for w in want)
    misses = 0
    for g, w in zip(got, want):
        diff = (g.double() - w.double()).abs()
        gate = CHIP.FLASH_BWD_F32 * scale \
            + CHIP.FLASH_BWD_BF16_STEP * w.double().abs()
        misses += int((diff > gate).sum())
    return misses


def _bf16_case(bh, sq, sk, d, dv, causal, window, q_offset, kv_len, seed=0):
    """bf16 operands, the plain forward's o and lse, the plain backward."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shape)
                                    .astype(np.float32)).bfloat16()
                   for shape in ((bh, sq, d), (bh, sk, d), (bh, sk, dv),
                                 (bh, sq, dv)))
    args = (causal, window, q_offset, kv_len)
    o, lse = k7.flash_attention_masked_plain(q, k, v, *args, with_lse=True)
    want = k7.flash_attention_masked_bwd_plain(q, k, v, o, lse, do, *args)
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


@pytest.mark.parametrize("terms,misses", [(1, True), (2, False)])
def test_bwd_term_count_against_the_bf16_gate(terms, misses):
    """One bf16 term of P and dS (2^-9 of each) misses the gate across 64
    causal heads; two (2^-18) meet it, as the kernel's three do."""
    args, want = _bf16_case(*BWD_WGMMA_CASES["d64_causal_64_heads"])
    got = emulate_bwd_wgmma(*args, terms)
    assert (bwd_gate_misses(got, want) > 0) == misses


def test_bwd_routes_by_dtype_and_width_to_built_entry_points():
    """bf16 up to kMaxD (granite's 64, Phi-3's 96, 128) and MLA's 192 /
    128 on the tensor cores; float32, and the other bf16 heads past 128,
    on the CUDA cores; each route names a C entry point the build binds."""
    from repro_torch.kernels._build import SIGNATURES

    assert BWD["kMaxD"] == 128
    assert (BWD["kWideD"], BWD["kWideDV"], BWD["kWideBT"]) == (192, 128, 32)
    for d in (7, 32, 64, 96, 128):
        assert k7.bwd_route(torch.bfloat16, d, d) == "wgmma"
        assert k7.bwd_route(torch.float32, d, d) == "cuda_cores"
    assert k7.bwd_route(torch.bfloat16, 96, 80) == "wgmma"
    assert k7.bwd_route(torch.bfloat16, 192, 128) == "wgmma"
    assert k7.bwd_route(torch.float32, 192, 128) == "cuda_cores"
    for d, dv in ((129, 129), (160, 160), (192, 192)):
        assert k7.bwd_route(torch.bfloat16, d, dv) == "cuda_cores"
    assert set(k7.BWD_KERNELS) == {"wgmma", "cuda_cores", "cuda_cores_slabs"}
    assert all(name in SIGNATURES for name in k7.BWD_KERNELS.values())


@pytest.mark.parametrize("d,dv,want", [
    (7, 7, (32, 32, 64)), (64, 64, (64, 64, 64)), (96, 80, (96, 96, 64)),
    (128, 128, (128, 128, 64)), (192, 128, (192, 128, 32)),
    (160, 128, (192, 128, 32))])
def test_bwd_widths_name_the_build_each_wgmma_call_launches(d, dv, want):
    """The template arguments (qk, value, dK/dV query tile) of the
    tensor-core build a call takes, as the source's entry point switches:
    the square builds pad D to a multiple of 32 with kBT-query tiles, and
    every head past kMaxD that the route sends there takes MLA's build."""
    assert k7.bwd_route(torch.bfloat16, d, dv) == "wgmma"
    assert k7.bwd_widths(d, dv) == want
