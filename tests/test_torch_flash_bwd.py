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
* The CUDA kernel's loop bounds (``csrc/flash_attention_bwd.cu``): its
  dK/dV pass visits, for each 64-key tile, the query tiles from the causal
  diagonal to the window's far edge; its dQ pass the key tiles the forward
  visits.  Emulated here over a grid of masks, every valid (query, key)
  pair must fall in a visited tile of both passes.
The CUDA kernel itself is held against the plain version on the card by
``chip_smoke.py`` (``train_phase``).
"""
import itertools

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


def _bwd_tiles_cover(sq, sk, causal, window, q_offset, kv_len, blk=64):
    """The kernel's loop bounds, as in csrc/flash_attention_bwd.cu, and
    whether they cover every valid pair."""
    kvl = min(kv_len, sk)
    qi = np.arange(sq)[:, None]
    kj = np.arange(sk)[None, :]
    p = qi + q_offset
    valid = (kj < kvl) & (kj <= p if causal else qi >= 0)
    if window > 0:
        valid = valid & (kj > p - window)
    seen_kv = np.zeros((sq, sk), bool)
    for k0 in range(0, sk, blk):  # dkdv_kernel
        k1 = min(k0 + blk, kvl)
        i_lo = max(0, k0 - q_offset) if causal else 0
        i_hi = min(sq, k1 - 1 + window - q_offset) if window > 0 else sq
        if k0 >= kvl:
            i_hi = i_lo
        t_lo = i_lo // blk
        t_hi = (i_hi + blk - 1) // blk if i_hi > i_lo else t_lo
        seen_kv[t_lo * blk:t_hi * blk, k0:k0 + blk] = True
    seen_q = np.zeros((sq, sk), bool)
    for q0 in range(0, sq, blk):  # dq_kernel
        last_q = min(q0 + blk, sq) - 1
        hi = min(kvl, last_q + q_offset + 1) if causal else kvl
        lo = max(0, q0 + q_offset - window + 1) if window > 0 else 0
        t_lo = lo // blk
        t_hi = (hi + blk - 1) // blk if hi > lo else t_lo
        seen_q[q0:q0 + blk, t_lo * blk:t_hi * blk] = True
    return bool(np.all(seen_kv[valid])) and bool(np.all(seen_q[valid]))


def test_kernel_tile_ranges_cover_every_valid_pair():
    for sq, sk, causal, window, q_offset, kv_len in itertools.product(
            (1, 63, 64, 130), (1, 64, 129, 200), (True, False), (0, 1, 17, 64),
            (0, 5, 70), (1, 60, 10**6)):
        assert _bwd_tiles_cover(sq, sk, causal, window, q_offset, kv_len), (
            sq, sk, causal, window, q_offset, kv_len)
