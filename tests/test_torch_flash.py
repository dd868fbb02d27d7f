"""The port's flash attention against the JAX package, on the CPU.

* K7's plain version (``kernels.flash_attention.flash_attention_fused_plain``,
  what ``ops.flash_attention_fused`` runs on a CPU tensor) against the
  reference's Pallas kernel in interpret mode, on
  ``tests/test_flash_kernel.py``'s 12 cases.  float32: within 1e-5 + 1e-5
  relative (both sum in float32, in another order).  bfloat16: the output is
  rounded to bfloat16 once, so a sum that lands near a rounding boundary
  may round the other way: within one bfloat16 step, 2**-7 relative.
* The port's model attention (``models.attention.flash_attention``) against
  the reference's, on the K7 route (the fused kernel's contract, now with
  windows, ``q_offset``, ``kv_valid_len``, Sq != Sk and ragged S: K7's
  masked entry, ``flash_attention_masked``) and the port's chunked code
  (``flash_attention_chunked``: window, ``q_offset``, ``kv_valid_len``,
  ragged S, GQA, ``p_dtype``, cross-attention).  The K7 route differs from
  the reference's chunked loop in its blocks (so the order of sums) and in
  its scale (``1/sqrt(D)`` rounded from double, one float32 ulp from
  ``1/sqrt(float32(D))`` for some D): within rtol 2e-4 / atol 2e-5, the
  reference's own kernel-vs-model bar (``test_flash_fused_matches_model_
  flash``).  The chunked code repeats the reference's arithmetic: within
  1e-5 relative / 1e-6; with ``p_dtype=bfloat16`` the probabilities are
  rounded to bfloat16, so a probability near a rounding boundary may round
  the other way: within 2**-8 relative / 1e-4.  Only ``p_dtype``, D > 192,
  Dv > D and a query without a valid key stay off K7's route, and raise
  off the CPU.
* ``ops`` routing: a CPU call launches nothing; the TPU backends raise.
* The bf16 kernel's arithmetic (``csrc/flash_attention_wgmma.cu``),
  emulated here, with the tile and the term count read from its source:
  bf16 q, k, v; float32 scores over tiles of ``kBK`` keys, scaled
  by ``1/sqrt(D)`` and ``log2(e)`` folded into one float32; the online
  softmax in base 2; P split into ``kPTerms`` bfloat16 terms, each
  multiplied by V into a float32 accumulator; the output rounded to
  bfloat16.  It is held to the plain version under ``chip_smoke.py``'s
  ``FLASH_TOL["torch.bfloat16"]``, the gate the kernel meets on the card.
  Two terms miss that gate on outputs near zero, where its absolute 1e-6
  binds; the kernel therefore carries three.
The CUDA kernels are held against the same plain version on the card by
``chip_smoke.py``.
"""
import importlib.util
import math
import pathlib

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
    # v may be narrower than q and k (MLA), never wider or of another S
    assert tuple(k7.flash_attention_fused(x, x, x[:, :, :8]).shape) == \
        (1, 96, 8)
    with pytest.raises(ValueError):
        k7.flash_attention_fused(x[:, :, :8], x[:, :, :8], x)
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
    """bf16 goes to the tensor-core kernel, float32 to the CUDA-core one;
    each names a C entry point the build binds."""
    from repro_torch.kernels._build import SIGNATURES

    assert k7.route(torch.bfloat16) == "wgmma"
    assert k7.route(torch.float32) == "cuda_cores"
    assert all(name in SIGNATURES for name, _ in k7.KERNELS.values())


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
    assert attention.on_k7_route(s, s, d, dv)
    spy = Spy(monkeypatch)
    got = attention.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                    causal=causal)
    assert spy.calls == 1
    want = ref_attn.flash_attention(*map(jnp.asarray, (q, k, v)),
                                    causal=causal)
    np.testing.assert_allclose(host(got), host(want), rtol=2e-4, atol=2e-5)


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
    # v wider than q and k: outside K7's Dv <= D
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
    got = attention.flash_attention_chunked(*map(torch.from_numpy,
                                                 (q, k, v)), **kw_port)
    assert spy.calls == 0
    want = ref_attn.flash_attention(*map(jnp.asarray, (q, k, v)), **kw_ref)
    assert tuple(got.shape) == want.shape
    if "p_dtype" in kw_ref:
        np.testing.assert_allclose(host(got), host(want), rtol=2 ** -8,
                                   atol=1e-4)
    else:
        np.testing.assert_allclose(host(got), host(want), rtol=1e-5,
                                   atol=1e-6)


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
    assert attention.on_k7_route(
        sq, sk, d, d, kw.get("window", 0), kw.get("q_offset", 0),
        kw.get("kv_valid_len"), None, kw.get("causal", True))
    spy = Spy(monkeypatch)
    got = attention.flash_attention(*map(torch.from_numpy, (q, k, v)), **kw)
    assert spy.calls == 1
    want = ref_attn.flash_attention(*map(jnp.asarray, (q, k, v)), **kw)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(host(got), host(want), rtol=2e-4, atol=2e-5)


# calls outside K7's route: (sq, sk, d, dv, window, q_offset, kv_len,
# p_dtype, causal)
REFUSED = {
    "p_dtype": (16, 16, 8, 8, 0, 0, None, torch.bfloat16, True),
    "d_past_192": (16, 16, 200, 200, 0, 0, None, None, True),
    "dv_past_d": (16, 16, 8, 16, 0, 0, None, None, True),
    "first_query_sees_nothing": (16, 16, 8, 8, 0, -1, None, None, True),
    "no_keys": (16, 16, 8, 8, 0, 0, 0, None, False),
    "window_past_the_keys": (8, 32, 8, 8, 4, 40, None, None, False),
    "last_query_past_the_window": (64, 64, 8, 8, 4, 0, 20, None, True),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_calls_outside_the_k7_route_raise_off_the_cpu(case):
    """Only p_dtype, D > 192, Dv > D and a query with no valid key stay
    outside the route; each raises on a tensor off the CPU, and the masked
    kernel entry refuses a query with no valid key itself."""
    sq, sk, d, dv, window, q_offset, kv_len, p_dtype, causal = REFUSED[case]
    assert not attention.on_k7_route(sq, sk, d, dv, window, q_offset,
                                     kv_len, p_dtype, causal)
    q = torch.zeros((1, sq, 2, d), device="meta")
    k = torch.zeros((1, sk, 2, d), device="meta")
    v = torch.zeros((1, sk, 2, dv), device="meta")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        attention.flash_attention(q, k, v, causal=causal, window=window,
                                  q_offset=q_offset, kv_valid_len=kv_len,
                                  p_dtype=p_dtype)
    if dv <= d <= k7.MAX_HEAD_DIM and p_dtype is None:
        x = torch.zeros((2, sq, d))
        y = torch.zeros((2, sk, d))
        with pytest.raises(ValueError, match="sees no key"):
            ops.flash_attention_masked(x, y, y, causal, window, q_offset,
                                       kv_len)


def test_chunked_route_raises_off_the_cpu():
    """Outside K7's contract the port has no kernel: a tensor that is not on
    the CPU raises instead of running the chunked code there."""
    q = torch.zeros((1, 16, 2, 8), device="meta")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        attention.flash_attention(q, q, q, p_dtype=torch.bfloat16)


def test_fused_matches_model_chunked_in_the_port():
    """The port's counterpart of ``test_flash_fused_matches_model_flash``:
    K7's plain version against the port's own chunked loop."""
    b, s, h, d = 2, 64, 4, 32
    q, k, v = map(torch.from_numpy, qkv(np.random.default_rng(1), b, s, s,
                                        h, h, d))
    chunked = attention.flash_attention_chunked(q, k, v, causal=True,
                                                q_chunk=32, k_chunk=32,
                                                kv_valid_len=s)
    fused = attention.flash_attention(q, k, v, causal=True)
    np.testing.assert_allclose(host(fused), host(chunked), rtol=2e-4,
                               atol=2e-5)


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


BF16_GATE = _chip_smoke().FLASH_TOL["torch.bfloat16"]  # (rtol, atol)
WGMMA = k7.wgmma_constants()  # the kernel's kv tile kBK, P's terms kPTerms
WGMMA_KEYS = WGMMA["kBK"]


def emulate_wgmma(q, k, v, causal: bool, terms: int, window: int = 0):
    """The bf16 kernel's rounding, step by step, on the CPU (v may be
    narrower than q and k, and of another length Sk).  Every row runs every
    kv tile: a tile the kernel skips for a row is wholly masked for it, and
    its terms are wiped once a real score arrives."""
    bh, s, d = q.shape
    c = float(np.float32(np.float64(np.float32(1.0 / d ** 0.5))
                         * math.log2(math.e)))
    qf, kf, vf = q.float(), k.float(), v.float()
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
        for _ in range(terms):
            term = p.bfloat16().float()
            pv += torch.matmul(term, vf[:, k0:k0 + WGMMA_KEYS])
            p = p - term
        acc = acc * corr + pv
        m = m_new
    return (acc / l.clamp_min(1e-30)).bfloat16()


def gate_misses(got, want):
    rtol, atol = BF16_GATE
    diff = (got.double() - want.double()).abs()
    return int((diff > atol + rtol * want.double().abs()).sum())


def bf16_qkv(seed, bh, s, d):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((bh, s, d))
                             .astype(np.float32)).bfloat16()
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
