"""The port's Mamba2 and RWKV6 blocks and the Zamba2 and RWKV6 stacks
against the JAX package, on the CPU.

Blocks (``models.mamba2``, ``models.rwkv6``) on one layer's reference
weights, with ``a_log``, ``dt_bias`` and ``u`` drawn away from their init
constants so that decay and bonus are exercised.  The stacks run
``smoke_config`` of ``zamba2-1.2b`` (4 Mamba2 layers, the shared block
after every 2 with a 16-token window, over S 64 so that the window masks)
and ``rwkv6-1.6b`` (4 layers, WKV chunks of 32) in float32 on the
reference's weights, carried across by ``params_from_numpy``.  Inputs come
from numpy seeds.

Tolerances:

* the depthwise causal conv adds its taps in the reference's order: bit
  for bit, float32 and bfloat16;
* ``softplus`` is ``logaddexp(x, 0)`` as ``jax.nn.softplus``; the two
  libraries' log1p/exp differ by up to two float32 ulps: rtol 2.5e-7;
* float32 blocks, the forward, the loss and logits sum in another order
  (einsums, the chunk carry, K7's blocks): within 1e-5 of the largest
  |value| (rtol 1e-4), the loss within 1e-5;
* bfloat16 blocks round their intermediates at other places (XLA keeps a
  fused elementwise chain in float32): within 2**-5 of the largest
  |value|, four bfloat16 steps at the top of the range;
* greedy tokens and prompts must be equal.
"""
import argparse
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as ref_smoke
from repro.launch import serve as ref_launch
from repro.models import mamba2 as ref_m2
from repro.models import rwkv6 as ref_rk
from repro.models import transformer as ref_tf
from repro.serve.engine import Request as RefRequest
from repro.serve.engine import ServeEngine as RefEngine
from repro_torch import configs
from repro_torch.kernels import ops
from repro_torch.launch import serve as launch_serve
from repro_torch.models import attention, mamba2, rwkv6, transformer
from repro_torch.serve import Request, ServeEngine
from repro_torch.sparse.formats import from_numpy

ARCHS = ["zamba2-1.2b", "rwkv6-1.6b"]
DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]
DTYPE_IDS = ["f32", "bf16"]


def host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def t(x):
    return from_numpy(np.asarray(x), "cpu")


def close(got, want, dtype=torch.float32):
    """Within 1e-5 (float32) or 2**-5 (bfloat16) of ``want``'s largest
    |value|."""
    scale = float(np.abs(host(want)).max())
    if dtype == torch.float32:
        np.testing.assert_allclose(host(got), host(want), rtol=1e-4,
                                   atol=1e-5 * scale)
    else:
        np.testing.assert_allclose(host(got), host(want), rtol=0,
                                   atol=2 ** -5 * scale)


def flat_params(params):
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    return {"/".join(str(getattr(p, "key", getattr(p, "name",
                                                   getattr(p, "idx", p))))
                     for p in path): np.asarray(leaf)
            for path, leaf in leaves}


_MODELS = {}


def models(arch):
    """(cfg, port cfg, reference params, port params) on the same
    weights."""
    if arch not in _MODELS:
        cfg = ref_smoke(arch)
        ref_params, _ = ref_tf.init_transformer(cfg, jax.random.PRNGKey(0))
        port_cfg = configs.smoke_config(arch)
        port = transformer.params_from_numpy(port_cfg, flat_params(ref_params),
                                             device="cpu")
        _MODELS[arch] = (cfg, port_cfg, ref_params, port)
    return _MODELS[arch]


def tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(
        np.int32)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

MAMBA = dict(expand=2, head_dim=16, state=16, conv=4)


@functools.lru_cache(maxsize=None)
def mamba_params(jdt, seed=1, d=64):
    rng = np.random.default_rng(seed)
    p = ref_m2.mamba2_init(jax.random.PRNGKey(seed), d, dtype=jdt, **MAMBA)
    p = p._replace(
        a_log=jnp.asarray(0.5 * rng.standard_normal(p.a_log.shape),
                          jnp.float32),
        dt_bias=jnp.asarray(rng.standard_normal(p.dt_bias.shape),
                            jnp.float32))
    return p, mamba2.Mamba2Params(*(t(w) for w in p))


@pytest.mark.parametrize("dtypes", DTYPES, ids=DTYPE_IDS)
def test_causal_conv_is_bit_for_bit(dtypes):
    jdt, _ = dtypes
    ref_p, p = mamba_params(jdt)
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.standard_normal((2, 40, p.conv_w.shape[1])), jdt)
    state = jnp.asarray(rng.standard_normal((2, 3, p.conv_w.shape[1])), jdt)
    for st in (None, state):
        want, want_state = ref_m2._causal_conv(x, ref_p.conv_w, st)
        got, got_state = mamba2._causal_conv(
            t(x), p.conv_w, None if st is None else t(st))
        np.testing.assert_array_equal(host(got), host(want))
        np.testing.assert_array_equal(host(got_state), host(want_state))


def test_softplus_matches_jax():
    x = np.concatenate([np.linspace(-40, 40, 20001),
                        [19.9, 20.0, 20.1, 25.0, 90.0]]).astype(np.float32)
    np.testing.assert_allclose(
        mamba2.softplus(torch.from_numpy(x)).numpy(),
        np.asarray(jax.nn.softplus(jnp.asarray(x))), rtol=2.5e-7, atol=0)


@pytest.mark.parametrize("dtypes", DTYPES, ids=DTYPE_IDS)
def test_mamba2_forward_and_decode(dtypes):
    jdt, tdt = dtypes
    ref_p, p = mamba_params(jdt)
    x = jnp.asarray(np.random.default_rng(3).standard_normal((2, 48, 64)),
                    jdt)
    got = mamba2.mamba2_forward(p, t(x), chunk=16, **MAMBA)  # 3 chunks
    assert got.dtype == tdt
    ref_forward = jax.jit(functools.partial(ref_m2.mamba2_forward, chunk=16,
                                            **MAMBA))
    close(got, ref_forward(ref_p, x), tdt)
    di, heads = mamba2.mamba2_dims(64, 2, 16, 16)
    ss_r = jnp.zeros((2, heads, 16, 16), jnp.float32)
    cs_r = jnp.zeros((2, 3, di + 32), jdt)
    ss, cs = t(ss_r), t(cs_r)
    ref_decode = jax.jit(functools.partial(ref_m2.mamba2_decode, **MAMBA))
    for i in range(8):
        y_r, ss_r, cs_r = ref_decode(ref_p, x[:, i:i + 1], ss_r, cs_r)
        y, ss, cs = mamba2.mamba2_decode(p, t(x[:, i:i + 1]), ss, cs,
                                         **MAMBA)
        close(y, y_r, tdt)
    assert ss.dtype == torch.float32
    close(ss, ss_r, tdt)  # float32, fed by the block's bf16 values
    np.testing.assert_array_equal(host(cs), host(cs_r))


@functools.lru_cache(maxsize=None)
def rwkv_params(jdt, seed=2, d=64, d_ff=128, heads=4):
    p = ref_rk.rwkv6_init(jax.random.PRNGKey(seed), d, d_ff, heads, jdt)
    p = p._replace(u=jnp.asarray(0.3 * np.random.default_rng(seed)
                                 .standard_normal(p.u.shape), jnp.float32))
    return p, rwkv6.RWKV6Params(*(t(w) for w in p))


@pytest.mark.parametrize("dtypes", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("chunk", [0, 16], ids=["per_token", "chunked"])
def test_rwkv6_time_and_channel_mix(dtypes, chunk):
    jdt, tdt = dtypes
    ref_p, p = rwkv_params(jdt)
    rng = np.random.default_rng(4)
    x = jnp.asarray(rng.standard_normal((2, 32, 64)), jdt)
    state = jnp.asarray(0.1 * rng.standard_normal((2, 4, 16, 16)),
                        jnp.float32)
    x_prev = jnp.asarray(rng.standard_normal((2, 64)), jdt)
    o_r, s_r, last_r = jax.jit(functools.partial(
        ref_rk.rwkv6_time_mix, n_heads=4, chunk=chunk))(
            ref_p, x, state=state, x_prev=x_prev)
    o, s, last = rwkv6.rwkv6_time_mix(p, t(x), n_heads=4, state=t(state),
                                      x_prev=t(x_prev), chunk=chunk)
    assert o.dtype == tdt and s.dtype == torch.float32
    close(o, o_r, tdt)
    close(s, s_r, tdt)  # float32, fed by the block's bf16 projections
    np.testing.assert_array_equal(host(last), host(last_r))
    c_r, _ = ref_rk.rwkv6_channel_mix(ref_p, x, x_prev=x_prev)
    c, _ = rwkv6.rwkv6_channel_mix(p, t(x), x_prev=t(x_prev))
    close(c, c_r, tdt)


def test_rwkv6_chunked_matches_per_token_in_the_port():
    """The prefill's chunked WKV and decode's recurrence sum in other
    orders; the reference's own bar for the two (tests/test_rwkv_chunked.py:
    rtol 1e-4 / 1e-5)."""
    _, p = rwkv_params(jnp.float32)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 64, 64)).astype(np.float32))
    o0, s0, _ = rwkv6.rwkv6_time_mix(p, x, n_heads=4, chunk=0)
    o1, s1, _ = rwkv6.rwkv6_time_mix(p, x, n_heads=4, chunk=8)
    np.testing.assert_allclose(host(o1), host(o0), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(host(s1), host(s0), rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# the stacks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_init_transformer_shapes_match_reference(arch):
    _, port_cfg, ref_params, _ = models(arch)
    params = transformer.init_transformer(
        port_cfg, torch.Generator().manual_seed(0), device="cpu")
    want = {k: (v.shape, str(v.dtype))
            for k, v in flat_params(ref_params).items()}
    got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for k, v in flat_params(params).items()}
    assert got == want
    assert sorted(want) == sorted(transformer.param_keys(port_cfg))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_reference(arch):
    cfg, port_cfg, ref_params, params = models(arch)
    toks = tokens(cfg, 2, 64)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    before = ops.launch_counts()
    h, aux = transformer.forward_hidden(port_cfg, params, t(toks))
    ref_h, _ = jax.jit(functools.partial(ref_tf.forward_hidden, cfg))(
        ref_params, jnp.asarray(toks))
    close(h, ref_h)
    assert float(aux) == 0.0
    loss = transformer.train_loss(port_cfg, params, {"tokens": t(toks),
                                                     "labels": t(labels)})
    ref_loss = jax.jit(functools.partial(ref_tf.train_loss, cfg))(
        ref_params, {"tokens": jnp.asarray(toks),
                     "labels": jnp.asarray(labels)})
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5,
                               atol=1e-5)
    assert ops.launch_counts() == before  # the plain K7 on the CPU


@pytest.mark.parametrize("arch", ARCHS)
def test_attention_calls_go_through_k7(arch, monkeypatch):
    """Zamba2: one windowed K7 call for each application of the shared
    block; RWKV6: none."""
    _, port_cfg, _, params = models(arch)
    calls = []
    real = attention.ops.flash_attention_masked

    def spy(q, k, v, causal=True, window=0, *args, **kwargs):
        calls.append((tuple(q.shape), causal, window))
        return real(q, k, v, causal, window, *args, **kwargs)

    monkeypatch.setattr(attention.ops, "flash_attention_masked", spy)
    transformer.forward_hidden(port_cfg, params, t(tokens(port_cfg, 2, 64)))
    want = [((2 * port_cfg.n_heads, 64, port_cfg.hd), True,
             port_cfg.sliding_window)] * transformer.n_shared_apps(port_cfg)
    assert calls == want
    assert len(calls) == (2 if arch == "zamba2-1.2b" else 0)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_reference_and_forward(arch):
    cfg, port_cfg, ref_params, params = models(arch)
    toks = tokens(cfg, 2, 24, seed=1)  # past zamba2's 16-token window
    cache = transformer.init_decode_cache(port_cfg, 2, 24, device="cpu")
    ref_cache = ref_tf.init_decode_cache(cfg, 2, 24)
    assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in cache.items()} == \
        {k: (v.shape, str(v.dtype)) for k, v in ref_cache.items()}
    ref_step = jax.jit(functools.partial(ref_tf.decode_step, cfg))
    for i in range(toks.shape[1]):
        logits, cache = transformer.decode_step(port_cfg, params, cache,
                                                t(toks[:, i:i + 1]))
        ref_logits, ref_cache = ref_step(ref_params, ref_cache,
                                         jnp.asarray(toks[:, i:i + 1]))
        close(logits, ref_logits)
    assert int(cache["pos"]) == toks.shape[1] == int(ref_cache["pos"])
    for key in cache:
        close(cache[key], ref_cache[key])
    # decode against the port's own full-sequence forward (the prefill's
    # chunked SSD / WKV against the per-token updates)
    h, _ = transformer.forward_hidden(port_cfg, params, t(toks))
    close(logits[:, 0], h[:, -1] @ params["lm_head"])


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_engine_matches_reference(arch):
    cfg, port_cfg, ref_params, params = models(arch)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, 4 + i % 3) for i in range(4)]
    eng = ServeEngine(port_cfg, params, batch_slots=3, max_seq=32)
    ref_eng = RefEngine(cfg, ref_params, batch_slots=3, max_seq=32)
    for pr in prompts:
        eng.submit(Request(prompt=pr, max_new_tokens=5))
        ref_eng.submit(RefRequest(prompt=pr, max_new_tokens=5))
    got, want = eng.run(), ref_eng.run()
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]
    assert len(got) == 3 and all(len(r.out_tokens) == 5 for r in got)


def served_tokens(text):
    """The ``-> [tokens]`` of each ``[serve] req`` line."""
    return [line.split("->", 1)[1].strip() for line in text.splitlines()
            if line.startswith("[serve] req")]


def launch_on_reference_weights(arch, argv, monkeypatch, capsys):
    """``launch.serve`` of the port and of the reference on the same
    smoke weights (the reference's, seed 0) and prompts (numpy seed 0): the
    printed tokens of each request, (port, reference)."""
    _, port_cfg, ref_params, params = models(arch)
    monkeypatch.setattr(transformer, "init_transformer",
                        lambda cfg, gen, device="cuda": params)
    done = launch_serve.main(argv + ["--smoke", "--device", "cpu"])
    got = served_tokens(capsys.readouterr().out)
    ns = argparse.Namespace(arch=arch, smoke=True, requests=3,
                            new_tokens=4, slots=4, max_seq=64)
    ref_launch.run_lm(ns)
    want = served_tokens(capsys.readouterr().out)
    assert [len(r.out_tokens) for r in done] == [4, 4, 4]
    return got, want


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_serve_prints_the_reference_tokens(arch, monkeypatch,
                                                  capsys):
    got, want = launch_on_reference_weights(
        arch, ["--arch", arch, "--requests", "3", "--new-tokens", "4"],
        monkeypatch, capsys)
    assert got == want and len(got) == 3
