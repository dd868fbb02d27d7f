"""The port's flash attention against the JAX package, on the CPU.

* K7's plain version (``kernels.flash_attention.flash_attention_fused_plain``,
  what ``ops.flash_attention_fused`` runs on a CPU tensor) against the
  reference's Pallas kernel in interpret mode, on
  ``tests/test_flash_kernel.py``'s 12 cases.  float32: within 1e-5 + 1e-5
  relative (both sum in float32, in another order).  bfloat16: the output is
  rounded to bfloat16 once, so a sum that lands near a rounding boundary
  may round the other way: within one bfloat16 step, 2**-7 relative.
* The port's model attention (``models.attention.flash_attention``) against
  the reference's: every call goes through K7's masked entry
  (``flash_attention_masked``), with windows, ``q_offset``,
  ``kv_valid_len``, Sq != Sk, ragged S, GQA, ``p_dtype``, cross-attention
  and the reference's chunk sizes (``CHUNKED``, which change nothing on
  K7's route).  K7 differs from the reference's chunked loop in its blocks
  (so the order of sums) and in its scale (``1/sqrt(D)`` rounded from
  double, one float32 ulp from ``1/sqrt(float32(D))`` for some D): within
  rtol 2e-4 / atol 2e-5, the reference's own kernel-vs-model bar
  (``test_flash_fused_matches_model_flash``); with ``p_dtype=bfloat16``
  the probabilities are rounded to bfloat16 in other blocks than the
  reference's, so a probability near a rounding boundary may round the
  other way: within 2**-8 relative / 1e-4.
* The calls K7 once refused (``REFUSED``: ``p_dtype``, D > 192, Dv > D and
  four kinds of query without a valid key) through K7's plain version
  against the reference's chunked attention: forward within rtol 2e-4 /
  atol 2e-5 (2**-8 / 1e-4 under ``p_dtype``), gradients through
  ``jax.grad`` within the same (under ``p_dtype`` within 2**-8 of the
  largest |gradient|: JAX rounds the cotangents of its bf16 product to
  bf16, a relative 2**-9 of each, which the difference in dS leaves
  relative to the largest gradient, not to each element); a keyless row
  at two key chunks; every case reaching K7's wrapper on the meta device.
* ``ops`` routing: a CPU call launches nothing; the TPU backends raise.
* The tensor-core kernel's arithmetic (``csrc/flash_wgmma.cuh``),
  emulated here, with the tile and the term counts read from its source:
  bf16 or float16 q, k, v; float32 scores over tiles of ``kBK`` keys,
  scaled by ``1/sqrt(D)`` and ``log2(e)`` folded into one float32; the
  online softmax in base 2; P split into ``kPTerms`` bfloat16 terms, or
  ``kPTermsF16`` float16 terms of ``p * 2**15``, each multiplied by V
  into a float32 accumulator; the output rounded to the inputs' type.  It
  is held to the plain version under ``chip_smoke.py``'s ``FLASH_TOL`` of
  that type, the gate the kernel meets on the card.  Two bf16 terms miss
  the bf16 gate on outputs near zero, where its absolute 1e-6 binds, and
  one f16 term the f16 gate; the kernel therefore carries three and two.
  Under ``p_dtype`` one term of P rounded to bf16 meets ``P_DTYPE_MEAN``
  and the full terms miss it; the wide builds' value slabs meet the gate.
* float16 calls through the plain version against the reference on the
  same float16 inputs, forward and ``jax.grad``.
The CUDA kernels are held against the same plain version on the card by
``chip_smoke.py``.
"""
import importlib.util
import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_fused as ref_fused
from repro.models import attention as ref_attn
from repro_torch.kernels import flash_attention as k7
from repro_torch.kernels import ops
from repro_torch.models import attention

DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]
DTYPE_IDS = ["f32", "bf16"]
KERNEL_CASES = [(2, 64, 32, 16, 16), (1, 128, 64, 32, 64), (3, 32, 16, 32, 16)]


def to_torch(x, dtype=torch.float32):
    """A host or JAX array -> torch ``dtype`` (bf16 values carried exactly)."""
    return torch.from_numpy(np.array(x, np.float32)).to(dtype)


def host(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtypes", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bh,s,d,qb,kb", KERNEL_CASES)
def test_k7_plain_matches_pallas(dtypes, causal, bh, s, d, qb, kb):
    jdt, tdt = dtypes
    rng = np.random.default_rng(0)
    q, k, v = (jnp.asarray(rng.standard_normal((bh, s, d)), jdt)
               for _ in range(3))
    want = ref_fused(q, k, v, causal=causal, q_blk=qb, k_blk=kb,
                     interpret=True)
    before = ops.launch_counts()
    got = ops.flash_attention_fused(to_torch(q, tdt), to_torch(k, tdt),
                                    to_torch(v, tdt), causal=causal,
                                    q_blk=qb, k_blk=kb)
    assert ops.launch_counts() == before  # the CPU runs the plain version
    assert got.dtype == tdt and tuple(got.shape) == (bh, s, d)
    if tdt == torch.float32:
        np.testing.assert_allclose(host(got), host(want), rtol=1e-5,
                                   atol=1e-5)
    else:
        np.testing.assert_allclose(host(got), host(want), rtol=2 ** -7,
                                   atol=1e-6)


def test_k7_keeps_the_reference_divisibility_contract():
    x = torch.zeros((1, 96, 16))
    with pytest.raises(AssertionError):
        k7.flash_attention_fused(x, x, x, q_blk=64, k_blk=64)
    # v may be narrower than q and k (MLA) or wider, never of another S
    assert tuple(k7.flash_attention_fused(x, x, x[:, :, :8]).shape) == \
        (1, 96, 8)
    assert tuple(k7.flash_attention_fused(x[:, :, :8], x[:, :, :8],
                                          x).shape) == (1, 96, 16)
    with pytest.raises(ValueError):
        k7.flash_attention_fused(x, x, x[:, :48])


def test_ops_routing():
    x = torch.zeros((1, 16, 8))
    before = ops.launch_counts()
    ops.flash_attention_fused(x, x, x, backend="xla")
    ops.flash_attention_fused(x, x, x)
    assert ops.launch_counts() == before
    for backend in ("pallas", "interpret"):
        with pytest.raises(ValueError):
            ops.flash_attention_fused(x, x, x, backend=backend)


def test_routes_by_dtype_to_built_entry_points():
    """bf16 and float16 go to the tensor-core kernel, float32 to the
    CUDA-core one; each names C entry points the build binds."""
    from repro_torch.kernels._build import SIGNATURES

    assert k7.route(torch.bfloat16) == "wgmma"
    assert k7.route(torch.float16) == "wgmma"
    assert k7.route(torch.float32) == "cuda_cores"
    assert all(name in SIGNATURES for names in k7.KERNELS.values()
               for name in names)


class Spy:
    """Counts the model's calls of K7 (``ops.flash_attention_masked``)."""

    def __init__(self, monkeypatch):
        self.calls = 0
        real = ops.flash_attention_masked

        def spy(*args, **kwargs):
            self.calls += 1
            return real(*args, **kwargs)

        monkeypatch.setattr(attention.ops, "flash_attention_masked", spy)


def qkv(rng, b, sq, sk, h, kv, d, dv=None):
    return (rng.standard_normal((b, sq, h, d)).astype(np.float32),
            rng.standard_normal((b, sk, kv, d)).astype(np.float32),
            rng.standard_normal((b, sk, kv, dv or d)).astype(np.float32))


@pytest.mark.parametrize("b,s,h,kv,d,causal", [
    (2, 64, 4, 4, 32, True), (2, 64, 4, 4, 32, False),
    (1, 256, 4, 2, 16, True), (2, 16, 6, 2, 8, True),
    (1, 128, 2, 1, 24, False), (1, 256, 2, 2, (24, 16), True),
])
def test_model_flash_k7_route(monkeypatch, b, s, h, kv, d, causal):
    d, dv = d if isinstance(d, tuple) else (d, d)  # qk and v widths
    q, k, v = qkv(np.random.default_rng(1), b, s, s, h, kv, d, dv)
    spy = Spy(monkeypatch)
    got = attention.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                    causal=causal)
    assert spy.calls == 1
    want = ref_attn.flash_attention(*map(jnp.asarray, (q, k, v)),
                                    causal=causal)
    np.testing.assert_allclose(host(got), host(want), rtol=2e-4, atol=2e-5)


# the reference's chunk sizes beside masks, GQA, p_dtype and Dv > D: K7
# takes each call whatever its chunks
CHUNKED = {
    "window": dict(shape=(2, 64, 64, 4, 4, 16), kw=dict(window=24,
                                                      q_chunk=16, k_chunk=32)),
    "q_offset": dict(shape=(1, 16, 64, 4, 2, 16),
                     kw=dict(q_offset=48, q_chunk=8, k_chunk=16)),
    "kv_valid_len": dict(shape=(2, 32, 32, 4, 4, 16),
                         kw=dict(kv_valid_len=20, causal=False, q_chunk=16,
                                 k_chunk=16)),
    "ragged": dict(shape=(1, 150, 150, 4, 4, 16), kw=dict(q_chunk=16,
                                                        k_chunk=32)),
    "gqa_ragged": dict(shape=(2, 200, 200, 6, 2, 16), kw=dict(q_chunk=64,
                                                             k_chunk=128)),
    "p_dtype": dict(shape=(2, 64, 64, 4, 2, 16), kw=dict(
        p_dtype=(jnp.bfloat16, torch.bfloat16), q_chunk=32, k_chunk=16)),
    "cross": dict(shape=(2, 8, 24, 4, 4, 16), kw=dict(causal=False)),
    # v wider than q and k
    "dv": dict(shape=(1, 32, 32, 2, 2, 8), dv=16, kw={}),
}


@pytest.mark.parametrize("case", sorted(CHUNKED))
def test_model_flash_chunked_route(monkeypatch, case):
    spec = CHUNKED[case]
    b, sq, sk, h, kv, d = spec["shape"]
    q, k, v = qkv(np.random.default_rng(2), b, sq, sk, h, kv, d,
                  spec.get("dv"))
    kw_ref, kw_port = dict(spec["kw"]), dict(spec["kw"])
    if "p_dtype" in kw_ref:
        kw_ref["p_dtype"], kw_port["p_dtype"] = kw_ref["p_dtype"]
    spy = Spy(monkeypatch)
    got = attention.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                    **kw_port)
    assert spy.calls == 1
    want = ref_attn.flash_attention(*map(jnp.asarray, (q, k, v)), **kw_ref)
    assert tuple(got.shape) == want.shape
    if "p_dtype" not in kw_ref:
        np.testing.assert_allclose(host(got), host(want), rtol=K7_TOL[0],
                                   atol=K7_TOL[1])
        return
    # K7 rounds P after other running maxima than the reference's chunks
    kw_abs = dict(kw_ref, p_dtype=None)
    wv = host(ref_attn.flash_attention(*map(jnp.asarray, (q, k, np.abs(v))),
                                       **kw_abs))
    err = np.abs(host(got) - host(want))
    assert (err <= P_DTYPE_BLOCKS * wv + K7_TOL[0] * np.abs(host(want))
            + K7_TOL[1]).all()


# K7's masked contract: (b, sq, sk, h, kv, d, kwargs); the model's route
# takes each through flash_attention_masked (its plain version here)
MASKED = {
    "window": ((2, 64, 64, 4, 4, 16), dict(window=24)),
    "window_1": ((1, 192, 192, 2, 2, 16), dict(window=1)),
    "window_past_block": ((1, 300, 300, 2, 1, 16), dict(window=100)),
    "window_noncausal": ((1, 64, 64, 2, 2, 16), dict(window=20,
                                                      causal=False)),
    "q_offset": ((1, 16, 64, 4, 2, 16), dict(q_offset=48)),
    "q_offset_window": ((1, 40, 200, 2, 2, 16), dict(q_offset=160,
                                                      window=64)),
    "kv_valid_len": ((2, 32, 32, 4, 4, 16), dict(kv_valid_len=20,
                                                 causal=False)),
    "kv_len_q_offset": ((1, 24, 160, 2, 2, 16), dict(kv_valid_len=150,
                                                      q_offset=120)),
    "cross": ((2, 7, 150, 4, 4, 16), dict(causal=False)),
    "cross_one_query": ((1, 1, 150, 2, 2, 16), dict(causal=False)),
    "cross_long_queries": ((1, 45, 150, 2, 2, 16), dict(causal=False)),
    "ragged": ((1, 150, 150, 4, 4, 16), {}),
    "ragged_noncausal": ((1, 150, 150, 4, 2, 16), dict(causal=False)),
    "one_token": ((2, 1, 1, 2, 2, 16), {}),
}


@pytest.mark.parametrize("case", sorted(MASKED))
def test_model_flash_masked_k7_route(monkeypatch, case):
    """Windows, a query offset, a key limit, Sq != Sk and ragged S go
    through K7 (its masked plain version on the CPU), against the
    reference's chunked attention with the same arguments."""
    (b, sq, sk, h, kv, d), kw = MASKED[case]
    q, k, v = qkv(np.random.default_rng(4), b, sq, sk, h, kv, d)
    spy = Spy(monkeypatch)
    got = attention.flash_attention(*map(torch.from_numpy, (q, k, v)), **kw)
    assert spy.calls == 1
    want = ref_attn.flash_attention(*map(jnp.asarray, (q, k, v)), **kw)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(host(got), host(want), rtol=2e-4, atol=2e-5)


# the calls that K7 once refused, each on its route now: (sq, sk, d, dv,
# window, q_offset, kv_len, p_dtype, causal)
REFUSED = {
    "p_dtype": (16, 16, 8, 8, 0, 0, None, torch.bfloat16, True),
    "d_past_192": (16, 16, 200, 200, 0, 0, None, None, True),
    "dv_past_d": (16, 16, 8, 16, 0, 0, None, None, True),
    "first_query_sees_nothing": (16, 16, 8, 8, 0, -1, None, None, True),
    "no_keys": (16, 16, 8, 8, 0, 0, 0, None, False),
    "window_past_the_keys": (8, 32, 8, 8, 4, 40, None, None, False),
    "last_query_past_the_window": (64, 64, 8, 8, 4, 0, 20, None, True),
}
# K7's route against the reference: rtol / atol, and under p_dtype (the
# probabilities rounded to bf16 in other blocks than the reference's)
K7_TOL = (2e-4, 2e-5)
P_DTYPE_TOL = (2 ** -8, 1e-4)
# p_dtype where K7's blocks are not the reference's chunks: each
# probability is rounded to bf16 (by at most 2**-8 of itself) after another
# running max, so the outputs differ by at most 2 * 2**-8 of sum_j w_j
# |v_j| (the attention of |v|) beyond K7_TOL
P_DTYPE_BLOCKS = 2 ** -7
# the p_dtype gradient, of the largest |gradient|: the reference's jax.grad
# rounds the cotangents of its bf16 P.V product (dP and dV) to bf16, a
# relative 2**-9 of each, which the difference of dS = P (dP - Delta)
# leaves relative to the largest gradient, not to each element
P_DTYPE_GRAD_TOL = 2 ** -8


def _refused_inputs(case, seed=5):
    sq, sk, d, dv = REFUSED[case][:4]
    rng = np.random.default_rng(seed)
    q, k, v = qkv(rng, 1, sq, sk, 2, 2, d, dv)
    ct = rng.standard_normal((1, sq, 2, dv)).astype(np.float32)
    return q, k, v, ct


def _refused_kw(case, k_chunk=1024):
    _, _, _, _, window, q_offset, kv_len, p_dtype, causal = REFUSED[case]
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              kv_valid_len=kv_len, k_chunk=k_chunk)
    ref_kw = dict(kw, p_dtype=None if p_dtype is None else jnp.bfloat16)
    return dict(kw, p_dtype=p_dtype), ref_kw


def _tol(case):
    return P_DTYPE_TOL if REFUSED[case][7] is not None else K7_TOL


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refused_calls_run_k7_forward(monkeypatch, case):
    """Each call K7 once refused goes through K7 (its plain version here)
    and gives the reference's output."""
    q, k, v, _ = _refused_inputs(case)
    kw, ref_kw = _refused_kw(case)
    spy = Spy(monkeypatch)
    got = attention.flash_attention(*map(torch.from_numpy, (q, k, v)), **kw)
    assert spy.calls == 1
    want = ref_attn.flash_attention(*map(jnp.asarray, (q, k, v)), **ref_kw)
    assert tuple(got.shape) == want.shape
    rtol, atol = _tol(case)
    np.testing.assert_allclose(host(got), host(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refused_calls_run_k7_backward(case):
    """Their gradients through K7's autograd Function (the plain backward
    here) against ``jax.grad`` of the reference's chunked attention."""
    q, k, v, ct = _refused_inputs(case)
    kw, ref_kw = _refused_kw(case)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    (attention.flash_attention(tq, tk, tv, **kw)
     * torch.from_numpy(ct)).sum().backward()

    def f(q, k, v):
        return jnp.sum(ref_attn.flash_attention(q, k, v, **ref_kw) * ct)

    want = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    for t, w in zip((tq, tk, tv), want):
        if REFUSED[case][7] is None:
            np.testing.assert_allclose(host(t.grad), host(w), rtol=K7_TOL[0],
                                       atol=K7_TOL[1])
        else:  # JAX rounds the bf16 product's cotangents to bf16 too
            err = np.abs(host(t.grad) - host(w)).max()
            assert err <= P_DTYPE_GRAD_TOL * np.abs(host(w)).max()


@pytest.mark.parametrize("k_chunk", [16, 24])
def test_keyless_rows_follow_the_reference_key_chunk(k_chunk):
    """A query without keys gets ``sum_{j<Sk} v_j / (ceil(Sk/kc) kc)``: at
    Sk 40 the chunk 16 pads to 48 keys and the chunk 24 to 48 too but with
    another order, and the row differs from the mean of v (40 keys)."""
    rng = np.random.default_rng(8)
    q, k, v = qkv(rng, 1, 8, 40, 2, 2, 8)
    kw = dict(causal=True, q_offset=-3, k_chunk=k_chunk)
    got = attention.flash_attention(*map(torch.from_numpy, (q, k, v)), **kw)
    want = ref_attn.flash_attention(*map(jnp.asarray, (q, k, v)), **kw)
    np.testing.assert_allclose(host(got), host(want), rtol=2e-4, atol=2e-5)
    den = k7.keyless_den(40, k_chunk)
    assert den == -(-40 // k_chunk) * k_chunk > 40
    np.testing.assert_allclose(host(got)[0, :3],
                               np.broadcast_to(v[0].sum(0) / den,
                                               (3, 2, 8)),
                               rtol=1e-5, atol=1e-6)


def test_every_refused_case_takes_k7_on_the_card_side(monkeypatch):
    """On meta tensors (the card's stand-in) each case reaches K7's
    wrapper once, with its p_dtype and k_chunk, and nothing raises."""
    calls = []

    def k7_stub(q, k, v, **kw):
        calls.append(kw)
        return q.new_empty((*q.shape[:2], v.shape[2]))

    monkeypatch.setattr(attention.ops, "flash_attention_masked", k7_stub)
    for case, spec in sorted(REFUSED.items()):
        sq, sk, d, dv, window, q_offset, kv_len, p_dtype, causal = spec
        q = torch.zeros((1, sq, 2, d), device="meta")
        k = torch.zeros((1, sk, 2, d), device="meta")
        v = torch.zeros((1, sk, 2, dv), device="meta")
        out = attention.flash_attention(q, k, v, causal=causal, window=window,
                                        q_offset=q_offset, k_chunk=48,
                                        kv_valid_len=kv_len, p_dtype=p_dtype)
        assert tuple(out.shape) == (1, sq, 2, dv)
        assert calls[-1]["p_dtype"] is p_dtype
        assert calls[-1]["k_chunk"] == 48
    assert len(calls) == len(REFUSED)


def test_decode_attention_matches_reference():
    rng = np.random.default_rng(3)
    b, smax, h, kv, d = 2, 16, 4, 2, 8
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    kc, vc = (rng.standard_normal((b, smax, kv, d)).astype(np.float32)
              for _ in range(2))
    for cache_len, window in ((5, 0), (16, 0), (11, 4)):
        got = attention.decode_attention(
            *map(torch.from_numpy, (q, kc, vc)),
            torch.tensor(cache_len, dtype=torch.int32), window=window)
        want = ref_attn.decode_attention(*map(jnp.asarray, (q, kc, vc)),
                                         jnp.asarray(cache_len, jnp.int32),
                                         window=window)
        np.testing.assert_allclose(host(got), host(want), rtol=1e-5,
                                   atol=1e-6)


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CHIP = _chip_smoke()
BF16_GATE = CHIP.FLASH_TOL["torch.bfloat16"]  # (rtol, atol)
F16_GATE = CHIP.FLASH_TOL["torch.float16"]
# the kernel's kv tile kBK, P's terms kPTerms (bf16) and kPTermsF16, the
# value slabs of its wide builds, f16's P scale 2**kF16PScaleLog2
WGMMA = k7.wgmma_constants()
WGMMA_KEYS = WGMMA["kBK"]
F16_P_SCALE = 2.0 ** WGMMA["kF16PScaleLog2"]


def _terms(p, terms, kind, p_dtype=None):
    """p (float32) as the kernel's ``terms`` A-operand terms, each in
    float32: bf16 terms as they are; f16 terms of p * 2**15, scaled back
    (exact: a power of two); under ``p_dtype`` p rounded to bf16 first."""
    scale = F16_P_SCALE if kind == "f16" else 1.0
    x = p * scale
    if p_dtype is not None:
        x = x.bfloat16().float()
    out = []
    for _ in range(terms):
        t = (x.half() if kind == "f16" else x.bfloat16()).float()
        out.append(t / scale)
        x = x - t
    return out


def emulate_wgmma(q, k, v, causal: bool, terms: int, window: int = 0,
                  p_dtype=None):
    """The tensor-core kernel's rounding, step by step, on the CPU (v may
    be narrower than q and k, and of another length Sk), for bf16 or
    float16 q, k and v (the kernel's 16-bit type is q's).  Every row runs
    every kv tile: a tile the kernel skips for a row is wholly masked for
    it, and its terms are wiped once a real score arrives.  Under
    ``p_dtype`` P is rounded to bf16 and taken as one term, and V is
    rounded to bf16 (float16's kernel rounds its V tiles to
    f16(bf16(v) / 2) in shared memory and scales the sum back by 2: the
    same values here)."""
    kind = "f16" if q.dtype == torch.float16 else "bf16"
    bh, s, d = q.shape
    c = float(np.float32(np.float64(np.float32(1.0 / d ** 0.5))
                         * math.log2(math.e)))
    qf, kf, vf = q.float(), k.float(), v.float()
    if p_dtype is not None:
        vf = (v.bfloat16().float() * 0.5).to(q.dtype).float() * 2.0
    m = torch.full((bh, s, 1), k7.NEG_INF)
    l = torch.zeros((bh, s, 1))
    acc = torch.zeros((bh, s, v.shape[2]))
    pos = torch.arange(max(s, k.shape[1]))
    for k0 in range(0, k.shape[1], WGMMA_KEYS):
        x = torch.matmul(qf, kf[:, k0:k0 + WGMMA_KEYS].transpose(1, 2)) * c
        kpos = pos[None, k0:min(k0 + WGMMA_KEYS, k.shape[1])]
        ok = kpos <= pos[:s, None] if causal \
            else torch.ones_like(kpos <= pos[:s, None])
        if window:
            ok = ok & (kpos > pos[:s, None] - window)
        if causal or window:
            x = torch.where(ok, x, k7.NEG_INF)
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        p = torch.exp2(x - m_new)
        corr = torch.exp2(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        pv = torch.zeros_like(acc)
        for term in _terms(p, terms, kind, p_dtype):
            pv += torch.matmul(term, vf[:, k0:k0 + WGMMA_KEYS])
        acc = acc * corr + pv
        m = m_new
    return (acc / l.clamp_min(1e-30)).to(q.dtype)


def emulate_wgmma_slabs(q, k, v, causal: bool, terms: int, slab: int):
    """The wide builds: one block a (query tile, value slab), each running
    the same online softmax over the full qk width and writing ``slab``
    columns of the output."""
    return torch.cat([emulate_wgmma(q, k, v[..., c:c + slab], causal, terms)
                      for c in range(0, v.shape[2], slab)], -1)


def gate_misses(got, want):
    rtol, atol = F16_GATE if want.dtype == torch.float16 else BF16_GATE
    diff = (got.double() - want.double()).abs()
    return int((diff > atol + rtol * want.double().abs()).sum())


def bf16_qkv(seed, bh, s, d, dtype=torch.bfloat16):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((bh, s, d))
                             .astype(np.float32)).to(dtype)
            for _ in range(3)]


# the reference test's shapes, a Phi-3-like head (D 96) at small S, and 64
# heads of it (the early causal rows of many heads, where outputs near zero
# test the split)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bh,s,d", [(2, 64, 32), (1, 128, 64), (3, 32, 16),
                                    (2, 256, 96), (64, 256, 96)])
def test_wgmma_arithmetic_meets_the_bf16_gate(causal, bh, s, d):
    q, k, v = bf16_qkv(0, bh, s, d)
    want = k7.flash_attention_fused_plain(q, k, v, causal, min(128, s),
                                          min(128, s))
    got = emulate_wgmma(q, k, v, causal, WGMMA["kPTerms"])
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert gate_misses(got, want) == 0


@pytest.mark.parametrize("causal", [True, False])
def test_wgmma_arithmetic_meets_the_bf16_gate_at_mla_widths(causal):
    """MLA's prefill widths, qk 192 (128 + 64 rope lanes) and v 128, on the
    early causal rows of 32 heads."""
    q, k, _ = bf16_qkv(0, 32, 256, 192)
    v = bf16_qkv(1, 32, 256, 128)[0]
    want = k7.flash_attention_fused_plain(q, k, v, causal)
    got = emulate_wgmma(q, k, v, causal, WGMMA["kPTerms"])
    assert got.shape == want.shape == (32, 256, 128)
    assert gate_misses(got, want) == 0


@pytest.mark.parametrize("causal,window,sk", [
    (True, 1, 256), (True, 64, 256), (True, 100, 256), (False, 0, 75),
    (False, 0, 300)])
def test_wgmma_arithmetic_meets_the_bf16_gate_under_masks(causal, window,
                                                          sk):
    """Windows (window 1: each row's one key, its first tiles all masked)
    and unequal lengths (Whisper's cross-attention at small size)."""
    q = bf16_qkv(0, 16, 256, 64)[0]
    k, v = bf16_qkv(1, 16, sk, 64)[:2]
    want = k7.flash_attention_masked_plain(q, k, v, causal, window)
    got = emulate_wgmma(q, k, v, causal, WGMMA["kPTerms"], window)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert gate_misses(got, want) == 0


def test_two_term_split_misses_the_bf16_gate():
    """Why P carries three terms: with two (2^-16 of p), outputs near zero
    on the early causal rows of 64 heads miss the gate's absolute 1e-6."""
    misses = 0
    for seed in range(3):
        q, k, v = bf16_qkv(seed, 64, 256, 96)
        want = k7.flash_attention_fused_plain(q, k, v, True)
        misses += gate_misses(emulate_wgmma(q, k, v, True, 2), want)
    assert misses > 0


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bh,s,d", [(2, 64, 32), (2, 256, 96), (64, 256, 96),
                                    (4, 1024, 96)])
def test_wgmma_f16_arithmetic_meets_the_f16_gate(causal, bh, s, d):
    """float16 on the tensor cores: f16 products, P in kPTermsF16 f16 terms
    of p * 2**15, against the plain version under the f16 gate."""
    q, k, v = bf16_qkv(0, bh, s, d, torch.float16)
    want = k7.flash_attention_fused_plain(q, k, v, causal, min(128, s),
                                          min(128, s))
    got = emulate_wgmma(q, k, v, causal, WGMMA["kPTermsF16"])
    assert got.dtype == torch.float16 and got.shape == want.shape
    assert gate_misses(got, want) == 0


def test_one_f16_term_misses_the_f16_gate():
    """Why float16's P carries two terms: one (2^-11 of p) misses the f16
    gate on the early causal rows of 64 heads."""
    q, k, v = bf16_qkv(0, 64, 256, 96, torch.float16)
    want = k7.flash_attention_fused_plain(q, k, v, True)
    assert gate_misses(emulate_wgmma(q, k, v, True, 1), want) > 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_wgmma_p_dtype_arithmetic_meets_the_p_dtype_gate(dtype):
    """``p_dtype`` on the tensor cores: one term of P rounded to bf16 (in
    f16, bf16(p) * 2**15), V rounded to bf16 (f16's halved in the wrapper),
    against the plain version on the kernel's key tile under
    ``chip_smoke.py``'s ``P_DTYPE_MEAN``; the full-precision terms miss
    it."""
    q, k, v = bf16_qkv(2, 16, 256, 64, dtype)
    want = k7.flash_attention_masked_plain(q, k, v, True,
                                           p_dtype=torch.bfloat16,
                                           k_blk=WGMMA_KEYS)
    got = emulate_wgmma(q, k, v, True, 1, p_dtype=torch.bfloat16)
    assert CHIP.error_share(got, want) <= CHIP.P_DTYPE_MEAN
    full = WGMMA["kPTermsF16" if dtype == torch.float16 else "kPTerms"]
    assert CHIP.error_share(emulate_wgmma(q, k, v, True, full), want) \
        > CHIP.P_DTYPE_MEAN


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d,dv", [(320, 320), (64, 300), (384, 100)])
def test_value_slab_arithmetic_meets_the_gate(dtype, d, dv):
    """The wide builds at small S: each value slab recomputes S over the
    full qk width and writes its columns; the slabs together meet the gate
    of the input type against the plain version."""
    dq, slab = k7.wgmma_widths(d, dv)
    assert max(d, dv) > WGMMA["kMaxD"] and dq >= d
    assert k7.route(dtype, d, dv) == "wgmma"
    q, k, _ = bf16_qkv(3, 2, 128, d, dtype)
    v = bf16_qkv(4, 2, 128, dv, dtype)[0]
    want = k7.flash_attention_fused_plain(q, k, v, True)
    terms = WGMMA["kPTermsF16" if dtype == torch.float16 else "kPTerms"]
    got = emulate_wgmma_slabs(q, k, v, True, terms, slab)
    assert got.shape == want.shape == (2, 128, dv)
    assert gate_misses(got, want) == 0


# float16 calls the reference computes too: (sq, sk, d, dv, p_dtype)
F16_GRAD_TOL = 2 ** -9
F16_REF_CASES = {"causal": (32, 32, 16, 16, None),
                 "dv_past_d": (16, 16, 8, 16, None),
                 "p_dtype": (16, 16, 8, 8, torch.bfloat16)}


@pytest.mark.parametrize("case", sorted(F16_REF_CASES))
def test_float16_plain_matches_reference(case):
    """float16 inputs through K7's plain forward and backward (the CPU's
    K7) against the reference's chunked attention and ``jax.grad`` of it on
    the same float16 inputs.  The forwards compute in float32 and round
    once to float16: within one f16 step (2**-10 of the value) beyond
    ``K7_TOL``.  The gradients within ``F16_GRAD_TOL`` of the largest
    |gradient|: ``jax.grad`` sums the cotangents of its float16 operands
    in float16, each add rounded to a step of the running sum, which
    leaves a small gradient off by a step of the large ones; under
    ``p_dtype`` ``P_DTYPE_GRAD_TOL`` more (its bf16 cotangents, as in
    float32)."""
    sq, sk, d, dv, p_dtype = F16_REF_CASES[case]
    rng = np.random.default_rng(9)
    q, k, v = (x.astype(np.float16) for x in qkv(rng, 1, sq, sk, 2, 2, d, dv))
    ct = rng.standard_normal((1, sq, 2, dv)).astype(np.float16)
    kw = dict(causal=True, p_dtype=p_dtype)
    ref_kw = dict(causal=True, p_dtype=None if p_dtype is None
                  else jnp.bfloat16)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    got = attention.flash_attention(tq, tk, tv, **kw)
    assert got.dtype == torch.float16
    want = ref_attn.flash_attention(*map(jnp.asarray, (q, k, v)), **ref_kw)
    rtol, atol = P_DTYPE_TOL if p_dtype is not None else K7_TOL
    np.testing.assert_allclose(host(got.detach()).astype(np.float32),
                               np.asarray(want, np.float32),
                               rtol=rtol + 2 ** -10, atol=atol)
    (got.float() * torch.from_numpy(ct).float()).sum().backward()

    def f(q, k, v):
        out = ref_attn.flash_attention(q, k, v, **ref_kw)
        return jnp.sum(out.astype(jnp.float32) * ct.astype(np.float32))

    grads = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    for t, w in zip((tq, tk, tv), grads):
        g, w = host(t.grad).astype(np.float32), np.asarray(w, np.float32)
        assert t.grad.dtype == torch.float16
        tol = F16_GRAD_TOL + (0 if p_dtype is None else P_DTYPE_GRAD_TOL)
        assert np.abs(g - w).max() <= tol * np.abs(w).max()
