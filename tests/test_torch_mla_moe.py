"""The port's MLA, MoE and dense-prefix LM path against the JAX package, on
the CPU.

Both packages run ``smoke_config`` of ``deepseek-v2-lite-16b`` (MLA with
qk 16 + 8 rope lanes and v 16, 4 routed experts top-2 + 1 shared, a dense
first layer) and ``llama4-scout-17b-a16e`` (GQA, 4 experts top-1, no shared
expert) in float32 on the same weights: the reference's
``init_transformer`` draws them and ``params_from_numpy`` carries them
across by their tree paths (a list index is a path element:
``prefix_layers/0/attn/wq``).  Inputs come from numpy seeds.

Tolerances are ``tests/test_torch_lm.py``'s: products and softmaxes sum in
another order (the expert products as batched matmuls; the full-sequence
attention on the K7 route with its 128-blocks and ``1/sqrt(D)`` rounded
from double), so blocks, the loss and logits within 1e-4 relative / 1e-5.
The final hidden state of the whole stack takes its absolute 1e-5 of its
largest |value|: each block agrees within 1e-6 absolute, but the residual
stream carries those differences through the layers, and llama4's smoke
stack ends 1.3e-5 apart on an element near 0 with |h| up to 4.
The chosen experts, greedy tokens and prompts must be equal: a router
near-tie that flipped an expert would fail
``test_moe_ffn_matches_reference`` naming the token.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as ref_smoke
from repro.models import attention as ref_attn
from repro.models import ffn as ref_ffn
from repro.models import transformer as ref_tf
from repro.serve.engine import Request as RefRequest
from repro.serve.engine import ServeEngine as RefEngine
from repro.serve.engine import greedy_generate as ref_greedy
from repro_torch import configs
from repro_torch.kernels import ops
from repro_torch.launch import serve as launch_serve
from repro_torch.models import attention, ffn, transformer
from repro_torch.serve import Request, ServeEngine, greedy_generate

ARCHS = ["deepseek-v2-lite-16b", "llama4-scout-17b-a16e"]
RTOL, ATOL = 1e-4, 1e-5


def host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(host(got), host(want), rtol=rtol, atol=atol)


def t(x):
    return torch.from_numpy(np.array(x))


def flat_params(params):
    """A parameter tree as {"layers/attn/wq": ndarray}; list indices are
    path elements ("prefix_layers/0/ln1")."""
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


class Spy:
    """Records the shapes of the model's K7 calls
    (``ops.flash_attention_masked``; q, v)."""

    def __init__(self, monkeypatch):
        self.calls = []
        real = ops.flash_attention_masked

        def spy(q, k, v, *args, **kwargs):
            self.calls.append((tuple(q.shape), tuple(v.shape)))
            return real(q, k, v, *args, **kwargs)

        monkeypatch.setattr(attention.ops, "flash_attention_masked", spy)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_init_transformer_shapes_match_reference(arch):
    cfg, port_cfg, ref_params, _ = models(arch)
    params = transformer.init_transformer(
        port_cfg, torch.Generator().manual_seed(0), device="cpu")
    want = {k: v.shape for k, v in flat_params(ref_params).items()}
    got = {k: tuple(v.shape) for k, v in flat_params(params).items()}
    assert got == want
    assert sorted(want) == sorted(transformer.param_keys(port_cfg))
    assert params["layers"]["ffn"].router.dtype == torch.float32
    w1 = params["layers"]["ffn"].w1
    d = cfg.d_model
    assert abs(float(w1.std()) - d ** -0.5) < 0.1 * d ** -0.5


def test_params_from_numpy_is_bit_for_bit_and_checks_keys():
    cfg, port_cfg, ref_params, params = models("deepseek-v2-lite-16b")
    flat = flat_params(ref_params)
    for key, got in flat_params(params).items():
        np.testing.assert_array_equal(got, flat[key])
    assert isinstance(params["layers"]["attn"], attention.MLAParams)
    assert isinstance(params["layers"]["ffn"], ffn.MoEParams)
    assert isinstance(params["prefix_layers"][0]["ffn"], ffn.FFNParams)
    del flat["prefix_layers/0/ffn/w2"]
    with pytest.raises(ValueError, match="expected the keys"):
        transformer.params_from_numpy(port_cfg, flat, device="cpu")


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

def _mla(cfg, seed):
    ref_p = ref_attn.mla_init(jax.random.PRNGKey(seed), cfg.d_model,
                              cfg.n_heads, cfg.mla, jnp.float32)
    return ref_p, attention.MLAParams(*(t(w) for w in ref_p))


def test_mla_forward_and_decode(monkeypatch):
    cfg = ref_smoke("deepseek-v2-lite-16b")
    m = cfg.mla
    ref_p, p = _mla(cfg, 4)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 256, cfg.d_model)).astype(np.float32)
    kw = dict(n_heads=cfg.n_heads, mla=cfg.mla, rope_theta=cfg.rope_theta)
    spy = Spy(monkeypatch)
    got = attention.mla_forward(p, t(x), **kw)
    # one K7 call at qk nope + rope, v of v_head_dim
    qk, vd = m.qk_nope_dim + m.qk_rope_dim, m.v_head_dim
    assert spy.calls == [((2 * cfg.n_heads, 256, qk),
                          (2 * cfg.n_heads, 256, vd))]
    close(got, jax.jit(functools.partial(ref_attn.mla_forward, **kw))(
        ref_p, x))
    lat = rng.standard_normal((2, 16, m.kv_lora)).astype(np.float32)
    krp = rng.standard_normal((2, 16, m.qk_rope_dim)).astype(np.float32)
    x1 = x[:, :1]
    out, lat2, krp2 = attention.mla_decode(
        p, t(x1), t(lat), t(krp), torch.tensor(5, dtype=torch.int32), **kw)
    r_out, r_lat, r_krp = ref_attn.mla_decode(
        ref_p, x1, lat, krp, jnp.asarray(5, jnp.int32), **kw)
    close(out, r_out)
    close(lat2, r_lat)
    close(krp2, r_krp)


@pytest.mark.parametrize("causal", [True, False])
def test_k7_route_takes_a_narrower_value(monkeypatch, causal):
    """qk 24 / v 16 (the smoke MLA widths) at S 384: three 128-blocks on
    the K7 route against the reference's chunked attention."""
    rng = np.random.default_rng(6)
    b, s, h, d, dv = 2, 384, 4, 24, 16
    q, k = (rng.standard_normal((b, s, h, d)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((b, s, h, dv)).astype(np.float32)
    spy = Spy(monkeypatch)
    got = attention.flash_attention(t(q), t(k), t(v), causal=causal)
    assert spy.calls == [((b * h, s, d), (b * h, s, dv))]
    want = ref_attn.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=causal)
    assert tuple(got.shape) == want.shape == (b, s, h, dv)
    np.testing.assert_allclose(host(got), host(want), rtol=2e-4, atol=2e-5)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def _moe(cfg, seed):
    ref_p = ref_ffn.moe_init(jax.random.PRNGKey(seed), cfg.d_model, cfg.moe,
                             jnp.float32)
    shared = None if ref_p.shared is None else \
        ffn.FFNParams(*(t(w) for w in ref_p.shared))
    return ref_p, ffn.MoEParams(t(ref_p.router), t(ref_p.w1), t(ref_p.w3),
                                t(ref_p.w2), shared)


@pytest.mark.parametrize("drops", [False, True], ids=["no_drop", "drop"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_matches_reference(arch, drops):
    cfg = ref_smoke(arch)
    e, k = cfg.moe.n_experts, cfg.moe.top_k
    # capacity E/k makes cap = T (no token dropped); 0.5 forces drops
    moe_cfg = dataclasses.replace(cfg.moe, capacity_factor=0.5 if drops
                                  else e / k)
    ref_p, p = _moe(cfg, 7)
    x = np.random.default_rng(8).standard_normal(
        (2, 64, cfg.d_model)).astype(np.float32)
    n = x.shape[0] * x.shape[1]
    cap = ffn.moe_capacity(n, moe_cfg)
    assert cap == (max(8, int(np.ceil(n * k / e * 0.5))) if drops else n)
    # the chosen experts, by token
    logits, experts, gates = ffn.moe_route(p, t(x.reshape(n, -1)), moe_cfg)
    ref_logits = np.asarray(x.reshape(n, -1) @ np.asarray(ref_p.router))
    _, want = jax.lax.top_k(jnp.asarray(ref_logits), k)
    flipped = np.nonzero((experts.numpy() != np.asarray(want)).any(1))[0]
    assert flipped.size == 0, f"router near-tie flipped tokens {flipped}"
    counts = np.bincount(np.asarray(want).ravel(), minlength=e)
    assert (counts.max() > cap) == drops
    got, aux = ffn.moe_ffn(p, t(x), moe_cfg)
    ref_out, ref_aux = jax.jit(functools.partial(ref_ffn.moe_ffn,
                                                 cfg=moe_cfg))(ref_p, x)
    close(got, ref_out)
    close(aux, ref_aux, 1e-5, 1e-6)
    close(gates.sum(-1), np.ones(n), 1e-6, 1e-6)


@pytest.mark.parametrize("arch,drops", [(ARCHS[0], True), (ARCHS[1], False)],
                         ids=["deepseek-drop", "llama4-no_drop"])
def test_moe_ffn_gradients_match_jax_grad(arch, drops):
    """d/d(x, router, w1, w3, w2, shared) of ``<ct, moe_ffn(x)> + aux``
    against ``jax.grad`` of the reference, float32, each within RTOL of
    its largest |gradient| (ATOL where that is below 1): the row gathers'
    backward (``take_rows``) adds the cotangent rows in stream order, as
    the reference's ``.at[].add``."""
    cfg = ref_smoke(arch)
    e, k = cfg.moe.n_experts, cfg.moe.top_k
    moe_cfg = dataclasses.replace(cfg.moe, capacity_factor=0.5 if drops
                                  else e / k)
    ref_p, p = _moe(cfg, 7)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((1, 32, cfg.d_model)).astype(np.float32)
    ct = rng.standard_normal(x.shape).astype(np.float32)

    def ref_loss(params, x):
        out, aux = ref_ffn.moe_ffn(params, x, cfg=moe_cfg)
        return jnp.sum(out * ct) + aux

    want_p, want_x = jax.jit(jax.grad(ref_loss, argnums=(0, 1)))(
        ref_p, jnp.asarray(x))
    leaves = [w.clone().requires_grad_() for w in (p.router, p.w1, p.w3,
                                                    p.w2)]
    shared = None if p.shared is None else ffn.FFNParams(
        *(w.clone().requires_grad_() for w in p.shared))
    xt = t(x).requires_grad_()
    out, aux = ffn.moe_ffn(ffn.MoEParams(*leaves, shared), xt, moe_cfg)
    (torch.sum(out * t(ct)) + aux).backward()
    got = [xt.grad, *(w.grad for w in leaves)]
    want = [want_x, want_p.router, want_p.w1, want_p.w3, want_p.w2]
    if shared is not None:
        got += [w.grad for w in shared]
        want += list(want_p.shared)
    for name, g, w in zip(("x", "router", "w1", "w3", "w2", "shared w1",
                           "shared w3", "shared w2"), got, want):
        w = np.asarray(w)
        err = float(np.abs(host(g) - w).max())
        assert err <= RTOL * max(float(np.abs(w).max()), ATOL / RTOL), \
            f"{arch} {name}: max |error| {err}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_gather_backward_is_the_references_scatter_add(dtype,
                                                           monkeypatch):
    """The dispatch gather ``xt[t_sorted]`` (k = 6 pairs a token, in the
    expert-sorted stream) through ``take_rows``: its backward equals the
    reference's ``zeros((T, D)).at[t_sorted].add(ct)`` bit for bit, in
    float32 and bf16 (each add rounded), for a cotangent of mixed
    magnitude whose sums change with the order of adds; and ``moe_ffn``
    routes its four row gathers through it (the combine's, whose dropped
    pairs read a zero row, through ``take_rows_padded``)."""
    rng = np.random.default_rng(12)
    n_tok, k, d = 48, 6, 8
    flat_e = rng.integers(0, 16, n_tok * k)
    order = np.argsort(flat_e, kind="stable")
    t_sorted = (order // k).astype(np.int64)
    big = rng.random((n_tok * k, d)) < 0.3
    ct = np.where(big, np.where(rng.random(big.shape) < 0.5, -300.0, 300.0),
                  rng.random(big.shape) + 0.5).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    want = np.asarray(jnp.zeros((n_tok, d), jdt).at[jnp.asarray(t_sorted)]
                      .add(jnp.asarray(ct, jdt)).astype(jnp.float32))
    _, vjp = jax.vjp(lambda a: a[jnp.asarray(t_sorted)],
                     jnp.zeros((n_tok, d), jdt))
    np.testing.assert_array_equal(
        np.asarray(vjp(jnp.asarray(ct, jdt))[0].astype(jnp.float32)), want)
    xt = torch.zeros((n_tok, d), dtype=tdt, requires_grad=True)
    ffn.take_rows(xt, torch.from_numpy(t_sorted)).backward(
        torch.from_numpy(ct).to(tdt))
    np.testing.assert_array_equal(xt.grad.float().numpy(), want)
    # the combine's gather: dropped pairs read the concatenated zero row,
    # and its gradient (sliced off in the reference) reaches no row
    slot = np.where(rng.random(n_tok * k) < 0.2, n_tok,
                    rng.integers(0, n_tok, n_tok * k)).astype(np.int64)
    _, vjp = jax.vjp(lambda a: jnp.concatenate(
        [a, jnp.zeros((1, d), jdt)])[jnp.asarray(slot)],
        jnp.zeros((n_tok, d), jdt))
    want_pad = np.asarray(vjp(jnp.asarray(ct, jdt))[0].astype(jnp.float32))
    y = torch.zeros((n_tok, d), dtype=tdt, requires_grad=True)
    ffn.take_rows_padded(y, torch.from_numpy(slot)).backward(
        torch.from_numpy(ct).to(tdt))
    np.testing.assert_array_equal(y.grad.float().numpy(), want_pad)
    # the order of adds shows: the pairs in reverse give other bits
    rev = np.asarray(jnp.zeros((n_tok, d), jdt)
                     .at[jnp.asarray(t_sorted[::-1])]
                     .add(jnp.asarray(ct[::-1], jdt)).astype(jnp.float32))
    assert not np.array_equal(rev, want)
    calls = []
    for name in ("take_rows", "take_rows_padded"):
        def spy(x, idx, *args, real=getattr(ffn, name), name=name):
            calls.append(name)
            return real(x, idx, *args)

        monkeypatch.setattr(ffn, name, spy)
    cfg = ref_smoke("deepseek-v2-lite-16b")
    _, p = _moe(cfg, 9)
    ffn.moe_ffn(p, torch.zeros((1, 16, cfg.d_model)), cfg.moe)
    assert sorted(calls) == ["take_rows"] * 3 + ["take_rows_padded"], calls


def test_moe_combine_adds_in_stream_order_without_index_add(monkeypatch):
    """The combine reads each token's k contributions in ascending expert
    order; no ``index_add_`` (atomics on the card) is called."""
    cfg = ref_smoke("deepseek-v2-lite-16b")
    _, p = _moe(cfg, 9)

    def refuse(*args, **kwargs):
        raise AssertionError("index_add_ called")

    monkeypatch.setattr(torch.Tensor, "index_add_", refuse)
    monkeypatch.setattr(torch.Tensor, "index_add", refuse)
    x = torch.from_numpy(np.random.default_rng(10).standard_normal(
        (1, 32, cfg.d_model)).astype(np.float32))
    out, _ = ffn.moe_ffn(p, x, cfg.moe)
    again, _ = ffn.moe_ffn(p, x, cfg.moe)
    assert torch.equal(out, again)


# ---------------------------------------------------------------------------
# the transformer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_reference(arch):
    cfg, port_cfg, ref_params, params = models(arch)
    toks = tokens(cfg, 2, 128)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    before = ops.launch_counts()
    h, aux = transformer.forward_hidden(port_cfg, params, t(toks))
    ref_h, ref_aux = jax.jit(functools.partial(ref_tf.forward_hidden, cfg))(
        ref_params, jnp.asarray(toks))
    close(h, ref_h, atol=ATOL * float(np.abs(np.asarray(ref_h)).max()))
    close(aux, ref_aux, 1e-5, 1e-6)
    assert float(aux) > 0.0
    loss = transformer.train_loss(port_cfg, params, {"tokens": t(toks),
                                                     "labels": t(labels)})
    ref_loss = jax.jit(functools.partial(ref_tf.train_loss, cfg))(
        ref_params, {"tokens": jnp.asarray(toks),
                     "labels": jnp.asarray(labels)})
    close(loss, ref_loss, 1e-5, 1e-5)
    assert ops.launch_counts() == before  # the plain K7 on the CPU


def test_forward_runs_every_layer_through_k7_route(monkeypatch):
    """The prefix layer and each MLA layer: one K7 call each, qk nope +
    rope, v of v_head_dim."""
    _, port_cfg, _, params = models("deepseek-v2-lite-16b")
    spy = Spy(monkeypatch)
    transformer.forward_hidden(port_cfg, params, t(tokens(port_cfg, 2, 256)))
    m = port_cfg.mla
    b_h = 2 * port_cfg.n_heads
    assert spy.calls == [((b_h, 256, m.qk_nope_dim + m.qk_rope_dim),
                          (b_h, 256, m.v_head_dim))] * port_cfg.n_layers


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_reference_and_forward(arch):
    cfg, port_cfg, ref_params, params = models(arch)
    toks = tokens(cfg, 2, 10, seed=1)
    cache = transformer.init_decode_cache(port_cfg, 2, 16, device="cpu")
    ref_cache = ref_tf.init_decode_cache(cfg, 2, 16)
    assert {k: tuple(v.shape) for k, v in cache.items()} == \
        {k: v.shape for k, v in ref_cache.items()}
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
    # decode agrees with the port's own full-sequence forward where that
    # drops no token: capacity E/k makes cap = T (decode's cap of 8 slots
    # holds its 2 tokens' k slots either way)
    moe = port_cfg.moe
    no_drop = dataclasses.replace(port_cfg, moe=dataclasses.replace(
        moe, capacity_factor=moe.n_experts / moe.top_k))
    h, _ = transformer.forward_hidden(no_drop, params, t(toks))
    close(logits[:, 0], h[:, -1] @ params["lm_head"])


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_engine_and_greedy_match_reference(arch):
    cfg, port_cfg, ref_params, params = models(arch)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, 4 + i % 3) for i in range(5)]
    eng = ServeEngine(port_cfg, params, batch_slots=3, max_seq=32)
    ref_eng = RefEngine(cfg, ref_params, batch_slots=3, max_seq=32)
    for pr in prompts:
        eng.submit(Request(prompt=pr, max_new_tokens=5))
        ref_eng.submit(RefRequest(prompt=pr, max_new_tokens=5))
    got, want = eng.run(), ref_eng.run()
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]
    assert len(got) == 3 and all(len(r.out_tokens) == 5 for r in got)
    assert len(eng.queue) == 2  # the fixed-slot engine leaves the rest queued
    np.testing.assert_array_equal(
        greedy_generate(port_cfg, params, prompts[0], 6, max_seq=16),
        ref_greedy(cfg, ref_params, prompts[0], 6, max_seq=16))


def test_launch_serve_deepseek_on_cpu(capsys):
    done = launch_serve.main(["--arch", "deepseek-v2-lite-16b", "--smoke",
                              "--device", "cpu", "--requests", "3",
                              "--new-tokens", "4"])
    assert [len(r.out_tokens) for r in done] == [4, 4, 4]
    assert capsys.readouterr().out.count("[serve] req") == 3


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "rwkv6-1.6b",
                                  "whisper-large-v3", "internvl2-76b"])
def test_mla_and_moe_are_no_longer_what_refuses(arch):
    """Nothing refuses these configs any more, MLA, MoE and a dense prefix
    layer included: the port runs every config's stack."""
    transformer.check_supported(configs.get_config(arch))
    transformer.check_supported(configs.smoke_config(arch))
