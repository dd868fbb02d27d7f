"""The port's Whisper encoder-decoder and InternVL2's vision stub against the
JAX package, on the CPU.

Both packages run ``smoke_config`` of ``whisper-large-v3`` (2 encoder and 4
decoder layers, every decoder layer with cross-attention) and
``internvl2-76b`` (the dense GQA backbone, 8 stub patch embeddings written
over the first positions) in float32 on the reference's weights, carried
across by ``params_from_numpy``.  Whisper's frames are ragged: 37 of them,
no multiple of any chunk or tile.  Inputs come from numpy seeds.

Tolerances are ``tests/test_torch_lm.py``'s: products and softmaxes sum in
another order (every attention on the K7 route: the encoder unmasked, the
decoder causal, the cross-attention with 64 queries against 37 keys), so
hidden states and logits within 1e-5 of their largest |value| (rtol 1e-4),
the loss within 1e-5.  Greedy tokens must be equal.
"""
import argparse
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as ref_smoke
from repro.launch import serve as ref_launch
from repro.launch.sharding import UNSHARDED
from repro.models import attention as ref_attn
from repro.models import transformer as ref_tf
from repro.serve.engine import Request as RefRequest
from repro.serve.engine import ServeEngine as RefEngine
from repro_torch import configs
from repro_torch.kernels import ops
from repro_torch.launch import serve as launch_serve
from repro_torch.models import attention, transformer
from repro_torch.serve import Request, ServeEngine
from repro_torch.sparse.formats import from_numpy

ARCHS = ["whisper-large-v3", "internvl2-76b"]
FRAMES = 37


def host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def t(x):
    return from_numpy(np.asarray(x), "cpu")


def close(got, want):
    scale = float(np.abs(host(want)).max())
    np.testing.assert_allclose(host(got), host(want), rtol=1e-4,
                               atol=1e-5 * scale)


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


def batch(cfg, b=2, s=64, seed=0):
    """Tokens, next-token labels and the config's stub inputs (host
    arrays)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    out = {"tokens": toks, "labels": labels}
    if cfg.frontend == "vision_stub":
        out["vision_embeds"] = rng.standard_normal(
            (b, cfg.vision_patches, cfg.d_model)).astype(np.float32)
    if cfg.encoder_layers:
        out["frames"] = rng.standard_normal(
            (b, FRAMES, cfg.d_model)).astype(np.float32)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_init_transformer_shapes_match_reference(arch):
    _, port_cfg, ref_params, _ = models(arch)
    params = transformer.init_transformer(
        port_cfg, torch.Generator().manual_seed(0), device="cpu")
    want = {k: v.shape for k, v in flat_params(ref_params).items()}
    got = {k: tuple(v.shape) for k, v in flat_params(params).items()}
    assert got == want
    assert sorted(want) == sorted(transformer.param_keys(port_cfg))


def test_encode_and_cross_attention_match_reference():
    cfg, port_cfg, ref_params, params = models("whisper-large-v3")
    frames = batch(cfg)["frames"]
    enc = transformer.encode(port_cfg, params, t(frames))
    ref_enc = ref_tf.encode(cfg, ref_params, jnp.asarray(frames), UNSHARDED)
    close(enc, ref_enc)
    # layer 0's cross-attention: 64 queries against the 37 frames' K/V
    lp = transformer.layer_params(params, 0)["cross"]
    ref_lp = jax.tree.map(lambda a: a[0], ref_params["layers"]["cross"])
    x = np.random.default_rng(1).standard_normal((2, 64, cfg.d_model)) \
        .astype(np.float32)
    kw = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, hd=cfg.hd,
              rope_theta=cfg.rope_theta)
    kv = attention.gqa_cross_kv(lp, enc, cfg.n_kv_heads, cfg.hd)
    got = attention.gqa_forward(lp, t(x), cross_kv=kv, **kw)
    ref_kv = ref_attn.gqa_cross_kv(ref_lp, ref_enc, cfg.n_kv_heads, cfg.hd)
    close(got, ref_attn.gqa_forward(ref_lp, jnp.asarray(x), cross_kv=ref_kv,
                                    **kw))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_reference(arch, monkeypatch):
    """Whisper with 37 frames, InternVL2 with its patch embeddings; every
    attention call through K7 (Whisper: the encoder's unmasked calls, then
    each decoder layer's causal and cross calls)."""
    cfg, port_cfg, ref_params, params = models(arch)
    host_batch = batch(cfg)
    calls = []
    real = attention.ops.flash_attention_masked

    def spy(q, k, v, causal=True, *args, **kwargs):
        calls.append((q.shape[1], k.shape[1], causal))
        return real(q, k, v, causal, *args, **kwargs)

    monkeypatch.setattr(attention.ops, "flash_attention_masked", spy)
    stubs = {k: v for k, v in host_batch.items() if k in ("vision_embeds",
                                                          "frames")}
    before = ops.launch_counts()
    h, _ = transformer.forward_hidden(
        port_cfg, params, t(host_batch["tokens"]),
        **{k: t(v) for k, v in stubs.items()})
    ref_h, _ = jax.jit(functools.partial(ref_tf.forward_hidden, cfg))(
        ref_params, jnp.asarray(host_batch["tokens"]),
        **{k: jnp.asarray(v) for k, v in stubs.items()})
    close(h, ref_h)
    if arch == "whisper-large-v3":
        assert calls == [(FRAMES, FRAMES, False)] * cfg.encoder_layers + \
            [(64, 64, True), (64, FRAMES, False)] * cfg.n_layers
    else:
        assert calls == [(64, 64, True)] * cfg.n_layers
    loss = transformer.train_loss(port_cfg, params,
                                  {k: t(v) for k, v in host_batch.items()})
    ref_loss = jax.jit(functools.partial(ref_tf.train_loss, cfg))(
        ref_params, {k: jnp.asarray(v) for k, v in host_batch.items()})
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5,
                               atol=1e-5)
    assert ops.launch_counts() == before  # the plain K7 on the CPU


def test_vision_stub_writes_the_first_positions():
    _, port_cfg, _, params = models("internvl2-76b")
    b = batch(port_cfg)
    with_stub, _ = transformer.forward_hidden(
        port_cfg, params, t(b["tokens"]), vision_embeds=t(b["vision_embeds"]))
    plain, _ = transformer.forward_hidden(port_cfg, params, t(b["tokens"]))
    assert not torch.equal(with_stub[:, 0], plain[:, 0])
    assert not torch.equal(with_stub[:, -1], plain[:, -1])  # causal reach


def test_decode_step_with_filled_cross_caches():
    """Whisper's decode over cross caches filled from the encoder's output
    through each layer's ``gqa_cross_kv`` (37 frames), against the
    reference's decode on the same caches and the port's own forward with
    the frames."""
    cfg, port_cfg, ref_params, params = models("whisper-large-v3")
    cfg = dataclasses.replace(cfg, encoder_seq=FRAMES)
    port_cfg = dataclasses.replace(port_cfg, encoder_seq=FRAMES)
    b = batch(cfg, s=12, seed=2)
    frames = b["frames"]
    enc = transformer.encode(port_cfg, params, t(frames))
    ref_enc = ref_tf.encode(cfg, ref_params, jnp.asarray(frames), UNSHARDED)
    cache = transformer.init_decode_cache(port_cfg, 2, 16, device="cpu")
    ref_cache = ref_tf.init_decode_cache(cfg, 2, 16)
    ref_ck, ref_cv = [], []
    for i in range(cfg.n_layers):
        k, v = attention.gqa_cross_kv(
            transformer.layer_params(params, i)["cross"], enc,
            cfg.n_kv_heads, cfg.hd)
        cache["cross_k"][i].copy_(k)
        cache["cross_v"][i].copy_(v)
        rk, rv = ref_attn.gqa_cross_kv(
            jax.tree.map(lambda a: a[i], ref_params["layers"]["cross"]),
            ref_enc, cfg.n_kv_heads, cfg.hd)
        ref_ck.append(rk)
        ref_cv.append(rv)
    ref_cache["cross_k"] = jnp.stack(ref_ck)
    ref_cache["cross_v"] = jnp.stack(ref_cv)
    ref_step = jax.jit(functools.partial(ref_tf.decode_step, cfg))
    toks = b["tokens"]
    for i in range(toks.shape[1]):
        logits, cache = transformer.decode_step(port_cfg, params, cache,
                                                t(toks[:, i:i + 1]))
        ref_logits, ref_cache = ref_step(ref_params, ref_cache,
                                         jnp.asarray(toks[:, i:i + 1]))
        close(logits, ref_logits)
    for key in ("k", "v"):
        close(cache[key], ref_cache[key])
    h, _ = transformer.forward_hidden(port_cfg, params, t(toks),
                                      frames=t(frames))
    close(logits[:, 0], h[:, -1] @ params["lm_head"])


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_engine_matches_reference(arch):
    """The servers, Whisper's on zero cross caches as the reference's."""
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


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_serve_prints_the_reference_tokens(arch, monkeypatch,
                                                  capsys):
    """``launch.serve --smoke --device cpu`` on the reference's seed-0
    weights prints the reference launcher's tokens for the same
    requests."""
    _, _, _, params = models(arch)
    monkeypatch.setattr(transformer, "init_transformer",
                        lambda cfg, gen, device="cuda": params)
    done = launch_serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                              "--requests", "3", "--new-tokens", "4"])
    got = served_tokens(capsys.readouterr().out)
    ref_launch.run_lm(argparse.Namespace(arch=arch, smoke=True, requests=3,
                                         new_tokens=4, slots=4, max_seq=64))
    want = served_tokens(capsys.readouterr().out)
    assert [len(r.out_tokens) for r in done] == [4, 4, 4]
    assert got == want and len(got) == 3
