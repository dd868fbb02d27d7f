"""The port's LM path (configs, common, FFN, GQA, transformer, serving)
against the JAX package, on the CPU.

Both packages run ``smoke_config`` of ``phi3-mini-3.8b`` (MHA) and
``granite-3-2b`` (GQA, 2 kv heads for 4 query heads) in float32 on the same
weights: the reference's ``init_transformer`` draws them and
``params_from_numpy`` carries them across by their tree paths.  Inputs come
from numpy seeds.

Tolerances: elementwise functions (``rms_norm``, ``apply_rope``) repeat the
reference's float32 arithmetic, within 1e-6 relative / 1e-6 (transcendental
functions of another library).  Products and softmaxes sum in another order
(and the full-sequence attention runs the K7 route with its 128-blocks and
``1/sqrt(D)`` rounded from double): blocks, the forward and the loss within
1e-4 relative / 1e-5.  Greedy tokens and prompts must be equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as ref_smoke
from repro.models import attention as ref_attn
from repro.models import common as ref_common
from repro.models import ffn as ref_ffn
from repro.models import transformer as ref_tf
from repro.serve.engine import Request as RefRequest
from repro.serve.engine import ServeEngine as RefEngine
from repro.serve.engine import greedy_generate as ref_greedy
from repro_torch import configs
from repro_torch.kernels import ops
from repro_torch.launch import serve as launch_serve
from repro_torch.models import attention, common, ffn, transformer
from repro_torch.serve import Request, ServeEngine, greedy_generate

ARCHS = ["phi3-mini-3.8b", "granite-3-2b"]
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
    """The reference's parameter tree as {"layers/attn/wq": ndarray}."""
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    return {"/".join(str(getattr(p, "key", getattr(p, "name", p)))
                     for p in path): np.asarray(leaf) for path, leaf in leaves}


_MODELS = {}


def models(arch):
    """(cfg, reference params, port params) on the same weights."""
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
# configs and the shared substrate
# ---------------------------------------------------------------------------

def test_configs_are_the_reference_table():
    from repro.configs import ARCH_IDS, get_config
    assert configs.ARCH_IDS == ARCH_IDS
    for name in ARCH_IDS:
        for ours, ref in ((configs.get_config(name), get_config(name)),
                          (configs.smoke_config(name), ref_smoke(name))):
            a, b = dataclasses.asdict(ours), dataclasses.asdict(ref)
            assert a == b, name
            assert ours.hd == ref.hd
            assert ours.n_params() == ref.n_params()
    assert configs.get_config("phi3-mini-3.8b").activation_dtype == \
        torch.bfloat16
    assert configs.smoke_config("phi3-mini-3.8b").activation_dtype == \
        torch.float32


def test_rms_norm_rope_and_masks():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 3, 16)).astype(np.float32)
    w = rng.standard_normal(16).astype(np.float32)
    close(common.rms_norm(t(x), t(w)), ref_common.rms_norm(x, w), 1e-6, 1e-6)
    b = rng.standard_normal(16).astype(np.float32)
    close(common.layer_norm(t(x), t(w), t(b)),
          ref_common.layer_norm(x, w, b), 1e-5, 1e-5)
    pos = rng.integers(0, 4096, (2, 8)).astype(np.int32)
    close(common.apply_rope(t(x), t(pos), 10000.0),
          ref_common.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0),
          1e-5, 1e-5)
    np.testing.assert_array_equal(
        common.causal_mask(5, 7, 2, device="cpu").numpy(),
        np.asarray(ref_common.causal_mask(5, 7, 2)))
    np.testing.assert_array_equal(
        common.sliding_window_mask(6, 6, 3, device="cpu").numpy(),
        np.asarray(ref_common.sliding_window_mask(6, 6, 3)))


def test_cross_entropy_chunked():
    rng = np.random.default_rng(1)
    h = rng.standard_normal((2, 8, 16)).astype(np.float32)
    w = rng.standard_normal((16, 40)).astype(np.float32)
    labels = rng.integers(-1, 40, (2, 8)).astype(np.int32)
    got = common.cross_entropy_chunked(lambda a, b: a @ b, t(h), t(labels),
                                       t(w), n_chunks=4)
    want = ref_common.cross_entropy_chunked(lambda a, b: a @ b, h, labels, w,
                                            n_chunks=4)
    close(got, want, 1e-5, 1e-5)


def _ffn_params(cfg, seed):
    p = ref_ffn.ffn_init(jax.random.PRNGKey(seed), cfg.d_model, cfg.d_ff,
                         jnp.float32)
    return p, ffn.FFNParams(*(t(w) for w in p))


def test_ffn_forms():
    cfg = ref_smoke("phi3-mini-3.8b")
    ref_p, p = _ffn_params(cfg, 1)
    x = np.random.default_rng(2).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32)
    close(ffn.swiglu(p, t(x)), ref_ffn.swiglu(ref_p, x))
    close(ffn.topk_ffn(p, t(x), 32), ref_ffn.topk_ffn(ref_p, x, 32))
    close(ffn.block_topk_ffn(p, t(x), 64, block=32, tile=8),
          ref_ffn.block_topk_ffn(ref_p, x, 64, block=32, tile=8))


def test_tile_block_select_picks_the_reference_blocks():
    h = np.random.default_rng(3).standard_normal((32, 256)).astype(np.float32)
    h_kept, bidx = ffn.tile_block_select(t(h), 3, 32, 8)
    energy = np.square(h.reshape(4, 8, 8, 32)).sum(axis=(1, 3))
    _, want = jax.lax.top_k(energy, 3)
    np.testing.assert_array_equal(bidx.numpy(), np.asarray(want))
    assert bidx.dtype == torch.int32 and tuple(h_kept.shape) == (4, 3, 8, 32)
    np.testing.assert_array_equal(
        h_kept.numpy(),
        h.reshape(4, 8, 8, 32).transpose(0, 2, 1, 3)[
            np.arange(4)[:, None], np.asarray(want)])


@pytest.mark.parametrize("arch", ARCHS)
def test_gqa_forward_and_decode(arch):
    cfg = ref_smoke(arch)
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    ref_p = ref_attn.gqa_init(jax.random.PRNGKey(4), cfg.d_model, h, kv, hd,
                              jnp.float32)
    p = attention.AttnParams(*(t(w) for w in ref_p))
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    kw = dict(n_heads=h, n_kv=kv, hd=hd, rope_theta=cfg.rope_theta)
    close(attention.gqa_forward(p, t(x), **kw),
          ref_attn.gqa_forward(ref_p, x, **kw))
    kc = rng.standard_normal((2, 16, kv, hd)).astype(np.float32)
    vc = rng.standard_normal((2, 16, kv, hd)).astype(np.float32)
    x1 = x[:, :1]
    out, kc2, vc2 = attention.gqa_decode(p, t(x1), t(kc), t(vc),
                                         torch.tensor(5, dtype=torch.int32),
                                         **kw)
    r_out, r_kc, r_vc = ref_attn.gqa_decode(ref_p, x1, kc, vc,
                                            jnp.asarray(5, jnp.int32), **kw)
    close(out, r_out)
    close(kc2, r_kc)
    close(vc2, r_vc)


# ---------------------------------------------------------------------------
# the transformer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_reference(arch):
    cfg, port_cfg, ref_params, params = models(arch)
    toks = tokens(cfg, 2, 64)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    before = ops.launch_counts()
    h, aux = transformer.forward_hidden(port_cfg, params, t(toks))
    ref_h, _ = ref_tf.forward_hidden(cfg, ref_params, jnp.asarray(toks))
    close(h, ref_h)
    assert float(aux) == 0.0
    loss = transformer.train_loss(port_cfg, params, {"tokens": t(toks),
                                                     "labels": t(labels)})
    ref_loss = ref_tf.train_loss(cfg, ref_params,
                                 {"tokens": jnp.asarray(toks),
                                  "labels": jnp.asarray(labels)})
    close(loss, ref_loss, 1e-5, 1e-5)
    assert ops.launch_counts() == before  # the plain K7 on the CPU


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_runs_every_layer_through_k7_route(arch, monkeypatch):
    _, port_cfg, _, params = models(arch)
    calls = []
    real = attention.ops.flash_attention_masked

    def spy(q, *args, **kwargs):
        calls.append(tuple(q.shape))
        return real(q, *args, **kwargs)

    monkeypatch.setattr(attention.ops, "flash_attention_masked", spy)
    transformer.forward_hidden(port_cfg, params, t(tokens(port_cfg, 2, 256)))
    b_h = 2 * port_cfg.n_heads
    assert calls == [(b_h, 256, port_cfg.hd)] * port_cfg.n_layers


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_reference_and_forward(arch):
    cfg, port_cfg, ref_params, params = models(arch)
    toks = tokens(cfg, 2, 12, seed=1)
    cache = transformer.init_decode_cache(port_cfg, 2, 16, device="cpu")
    ref_cache = ref_tf.init_decode_cache(cfg, 2, 16)
    for i in range(toks.shape[1]):
        logits, cache = transformer.decode_step(port_cfg, params, cache,
                                                t(toks[:, i:i + 1]))
        ref_logits, ref_cache = ref_tf.decode_step(
            cfg, ref_params, ref_cache, jnp.asarray(toks[:, i:i + 1]))
        close(logits, ref_logits)
    assert int(cache["pos"]) == toks.shape[1] == int(ref_cache["pos"])
    close(cache["k"], ref_cache["k"])
    # decode agrees with the port's own full-sequence forward
    h, _ = transformer.forward_hidden(port_cfg, params, t(toks))
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


def test_init_transformer_shapes_match_reference():
    cfg, port_cfg, ref_params, _ = models("granite-3-2b")
    params = transformer.init_transformer(
        port_cfg, torch.Generator().manual_seed(0), device="cpu")
    want = {k: v.shape for k, v in flat_params(ref_params).items()}
    got = {k: tuple(v.shape) for k, v in flat_params(params).items()}
    assert got == want
    w = params["layers"]["attn"].wq
    assert abs(float(w.std()) - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5


def test_launch_serve_lm_mode_on_cpu(capsys):
    done = launch_serve.main(["--arch", "phi3-mini-3.8b", "--smoke",
                              "--device", "cpu", "--requests", "3",
                              "--new-tokens", "4"])
    assert [len(r.out_tokens) for r in done] == [4, 4, 4]
    assert capsys.readouterr().out.count("[serve] req") == 3
    with pytest.raises(SystemExit):  # LM mode needs --arch
        launch_serve.main(["--smoke", "--device", "cpu"])
