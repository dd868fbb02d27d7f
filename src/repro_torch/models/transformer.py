"""The LM backbone for the attention+FFN stacks ('A' blocks): GQA/MHA or
MLA attention, dense or MoE FFN, and DeepSeek-V2's dense prefix layer.

Counterpart of ``repro.models.transformer`` for the configs of the dense
GQA family (phi3-mini, granite, deepseek-67b, internlm2) and the MoE family
(deepseek-v2-lite: MLA, 64 routed + 2 shared experts, a dense first layer;
llama4-scout: GQA, top-1 MoE).  Parameters are plain dicts of tensors in
the reference's tree, with the per-layer weights stacked on a leading layer
axis (``params["layers"]["attn"].wq`` is ``(L, D, H*hd)``) and a dense
prefix layer as ``params["prefix_layers"][0]``; the layers run as a Python
loop where the reference scans.  Attention goes through
``models.attention`` and so, for a full-sequence forward, through the fused
flash kernel (K7), MLA's expanded prefill included.

Not ported yet (ROADMAP Queue A item 12): Mamba2 ('M') and RWKV6 ('R')
blocks, the whisper encoder and the vision/audio frontends; a config that
needs one raises ``NotImplementedError``.  ``param_specs`` (sharding) and
``moe_ffn_shard_map`` wait for the multi-device pieces.
"""
from __future__ import annotations

from typing import Dict, List, Mapping

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import ffn as ffn_mod
from repro_torch.models.common import (cross_entropy_chunked, dense_init,
                                       rms_norm)
from repro_torch.sparse.formats import from_numpy


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for a config outside this port's stack."""
    missing = []
    if cfg.attention not in ("gqa", "mla"):
        missing.append(f"attention={cfg.attention!r}")
    if set(cfg.block_pattern) != {"A"}:
        missing.append(f"block pattern {cfg.block_pattern!r} (Mamba2/RWKV6)")
    if cfg.encoder_layers:
        missing.append("the encoder and cross-attention")
    if cfg.frontend != "none":
        missing.append(f"the {cfg.frontend} frontend")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported yet "
            f"(ROADMAP Queue A item 12)")


def is_moe(cfg: ArchConfig) -> bool:
    return bool(cfg.moe and cfg.moe.n_experts)


def n_prefix(cfg: ArchConfig) -> int:
    """Dense prefix layers ahead of the stack (DeepSeek-V2's first)."""
    return 1 if cfg.first_layer_dense_ffn else 0


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _attn_init(cfg: ArchConfig, generator, layers=None):
    dtype = cfg.activation_dtype
    if cfg.attention == "mla":
        return attn.mla_init(generator, cfg.d_model, cfg.n_heads, cfg.mla,
                             dtype, layers=layers)
    return attn.gqa_init(generator, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                         cfg.hd, dtype, layers=layers)


def init_transformer(cfg: ArchConfig, generator: torch.Generator,
                     device="cuda") -> Dict:
    """Random parameters from ``generator`` (drawn on its device), on
    ``device``: embedding N(0, 0.02²), projections N(0, 1/d_in), a MoE
    router in float32, norms 1, as the reference draws them (not its
    numbers).  MoE layers are drawn and placed one at a time."""
    check_supported(cfg)
    dtype = cfg.activation_dtype
    d, n = cfg.d_model, cfg.n_layers - n_prefix(cfg)
    embed = torch.randn((cfg.vocab, d), generator=generator,
                        dtype=torch.float32, device=generator.device) * 0.02
    params = {
        "embed": embed.to(dtype),
        "out_norm": torch.ones((d,), dtype=dtype),
        "lm_head": dense_init(generator, d, cfg.vocab, dtype),
        "layers": {
            "ln1": torch.ones((n, d), dtype=dtype),
            "attn": _attn_init(cfg, generator, layers=n),
            "ln2": torch.ones((n, d), dtype=dtype),
        },
    }
    params = _map(params, lambda t: t.to(device))
    if is_moe(cfg):
        params["layers"]["ffn"] = ffn_mod.moe_init(
            generator, d, cfg.moe, dtype, layers=n, device=device)
    else:
        params["layers"]["ffn"] = _map(
            ffn_mod.ffn_init(generator, d, cfg.d_ff, dtype, layers=n),
            lambda t: t.to(device))
    if n_prefix(cfg):
        params["prefix_layers"] = [_map({
            "ln1": torch.ones((d,), dtype=dtype),
            "ln2": torch.ones((d,), dtype=dtype),
            "attn": _attn_init(cfg, generator),
            "ffn": ffn_mod.ffn_init(generator, d, cfg.d_ff, dtype),
        }, lambda t: t.to(device)) for _ in range(n_prefix(cfg))]
    return params


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, fn) for v in tree]
    if isinstance(tree, tuple):
        return type(tree)(*(_map(v, fn) for v in tree))
    if tree is None:
        return None
    return fn(tree)


def _attn_cls(cfg: ArchConfig):
    return attn.MLAParams if cfg.attention == "mla" else attn.AttnParams


def param_keys(cfg: ArchConfig) -> List[str]:
    """The reference's tree paths of ``cfg``'s parameters, layer axis first
    under ``layers/``; a list's index is a path element
    (``prefix_layers/0/attn/wq``)."""
    keys = ["embed", "out_norm", "lm_head", "layers/ln1", "layers/ln2"]
    keys += [f"layers/attn/{w}" for w in _attn_cls(cfg)._fields]
    if is_moe(cfg):
        keys += [f"layers/ffn/{w}" for w in ("router", "w1", "w3", "w2")]
        if cfg.moe.n_shared:
            keys += [f"layers/ffn/shared/{w}"
                     for w in ffn_mod.FFNParams._fields]
    else:
        keys += [f"layers/ffn/{w}" for w in ffn_mod.FFNParams._fields]
    for i in range(n_prefix(cfg)):
        keys += [f"prefix_layers/{i}/{w}" for w in ("ln1", "ln2")]
        keys += [f"prefix_layers/{i}/attn/{w}"
                 for w in _attn_cls(cfg)._fields]
        keys += [f"prefix_layers/{i}/ffn/{w}"
                 for w in ffn_mod.FFNParams._fields]
    return keys


def params_from_numpy(cfg: ArchConfig, flat: Mapping[str, np.ndarray],
                      device="cuda") -> Dict:
    """Parameters from host arrays keyed by the reference's tree paths
    (``param_keys``: ``"layers/attn/wq"``, layer axis first), bit for bit
    (bfloat16 included, through ``sparse.formats.from_numpy``)."""
    check_supported(cfg)
    keys = param_keys(cfg)
    if set(flat) != set(keys):
        raise ValueError(f"expected the keys {sorted(keys)}, got "
                         f"{sorted(flat)}")

    def t(key):
        return from_numpy(flat[key], device)

    def attn_at(prefix):
        cls = _attn_cls(cfg)
        return cls(*(t(f"{prefix}/{w}") for w in cls._fields))

    def dense_at(prefix):
        return ffn_mod.FFNParams(*(t(f"{prefix}/{w}")
                                   for w in ffn_mod.FFNParams._fields))

    if is_moe(cfg):
        ffn = ffn_mod.MoEParams(
            *(t(f"layers/ffn/{w}") for w in ("router", "w1", "w3", "w2")),
            dense_at("layers/ffn/shared") if cfg.moe.n_shared else None)
    else:
        ffn = dense_at("layers/ffn")
    params = {
        "embed": t("embed"), "out_norm": t("out_norm"),
        "lm_head": t("lm_head"),
        "layers": {"ln1": t("layers/ln1"), "attn": attn_at("layers/attn"),
                   "ln2": t("layers/ln2"), "ffn": ffn},
    }
    if n_prefix(cfg):
        params["prefix_layers"] = [
            {"ln1": t(f"prefix_layers/{i}/ln1"),
             "ln2": t(f"prefix_layers/{i}/ln2"),
             "attn": attn_at(f"prefix_layers/{i}/attn"),
             "ffn": dense_at(f"prefix_layers/{i}/ffn")}
            for i in range(n_prefix(cfg))]
    return params


def layer_params(params: Dict, i: int) -> Dict:
    """Layer ``i``'s parameters (views into the stacked tensors)."""
    return _map(params["layers"], lambda a: a[i])


# ---------------------------------------------------------------------------
# Blocks (train/prefill)
# ---------------------------------------------------------------------------

def _ffn_apply(cfg: ArchConfig, lp, x):
    """The layer's FFN: (y, aux), aux the MoE's load-balance loss or 0."""
    if isinstance(lp["ffn"], ffn_mod.MoEParams):
        return ffn_mod.moe_ffn(lp["ffn"], x, cfg.moe)
    if cfg.ffn_mode == "topk" and cfg.topk_k:
        return ffn_mod.topk_ffn(lp["ffn"], x, cfg.topk_k), 0.0
    if cfg.ffn_mode == "block_topk" and cfg.topk_k:
        return ffn_mod.block_topk_ffn(lp["ffn"], x, cfg.topk_k,
                                      block=cfg.topk_block), 0.0
    return ffn_mod.swiglu(lp["ffn"], x), 0.0


def _attn_block(cfg: ArchConfig, lp, x, dense_ffn: bool = False):
    """Causal attention + FFN: (x, aux).  A config of these families
    attends without a window (the reference passes ``sliding_window``
    only to hybrids); ``dense_ffn`` is the prefix layer's SwiGLU."""
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    p_dtype = torch.bfloat16 if cfg.attn_p_dtype == "bfloat16" else None
    if cfg.attention == "mla":
        a = attn.mla_forward(lp["attn"], h, n_heads=cfg.n_heads, mla=cfg.mla,
                             rope_theta=cfg.rope_theta,
                             attn_chunk=cfg.attn_chunk, p_dtype=p_dtype)
    else:
        a = attn.gqa_forward(
            lp["attn"], h, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
            hd=cfg.hd, rope_theta=cfg.rope_theta, causal=True, window=0,
            attn_chunk=cfg.attn_chunk, p_dtype=p_dtype)
    x = x + a
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    if dense_ffn:
        return x + ffn_mod.swiglu(lp["ffn"], h), 0.0
    y, aux = _ffn_apply(cfg, lp, h)
    return x + y, aux


def forward_hidden(cfg: ArchConfig, params: Dict, tokens: torch.Tensor):
    """tokens (B, S) -> (final hidden (B, S, D), aux loss): the prefix
    layers with their dense FFN, then the stack; aux sums the MoE layers'
    load-balance losses in layer order (0 without MoE)."""
    check_supported(cfg)
    x = params["embed"][tokens.long()]
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in params.get("prefix_layers", []):
        x, aux = _attn_block(cfg, lp, x, dense_ffn=True)
        aux_total = aux_total + aux
    for i in range(params["layers"]["ln1"].shape[0]):
        x, aux = _attn_block(cfg, layer_params(params, i), x)
        aux_total = aux_total + aux
    return rms_norm(x, params["out_norm"], cfg.norm_eps), aux_total


def train_loss(cfg: ArchConfig, params: Dict, batch: Mapping) -> torch.Tensor:
    """batch: {"tokens": (B, S), "labels": (B, S)} -> mean next-token loss
    plus 0.01 × the MoE aux loss.  On the card, call it under
    ``torch.no_grad()``: the flash kernel has no backward yet."""
    h, aux = forward_hidden(cfg, params, batch["tokens"])
    loss = cross_entropy_chunked(lambda hh, w: hh @ w, h, batch["labels"],
                                 params["lm_head"], cfg.loss_chunks)
    return loss + 0.01 * aux


# ---------------------------------------------------------------------------
# Decode (serve step)
# ---------------------------------------------------------------------------

def init_decode_cache(cfg: ArchConfig, batch: int, max_seq: int, dtype=None,
                      device="cuda") -> Dict:
    """Caches stacked on a leading per-layer axis, and one shared position
    ``pos`` (a 0-d int32 tensor) for the whole batch: K/V for GQA; for MLA
    the latent and the rope key, ``p_latent``/``p_krope`` for the prefix
    layers."""
    check_supported(cfg)
    dtype = dtype or cfg.activation_dtype
    n = cfg.n_layers - n_prefix(cfg)
    cache = {"pos": torch.zeros((), dtype=torch.int32, device=device)}

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    if cfg.attention == "mla":
        m = cfg.mla
        cache["latent"] = zeros(n, batch, max_seq, m.kv_lora)
        cache["krope"] = zeros(n, batch, max_seq, m.qk_rope_dim)
        if n_prefix(cfg):
            cache["p_latent"] = zeros(n_prefix(cfg), batch, max_seq,
                                      m.kv_lora)
            cache["p_krope"] = zeros(n_prefix(cfg), batch, max_seq,
                                     m.qk_rope_dim)
    else:
        cache["k"] = zeros(n, batch, max_seq, cfg.n_kv_heads, cfg.hd)
        cache["v"] = zeros(n, batch, max_seq, cfg.n_kv_heads, cfg.hd)
    return cache


def _decode_attn(cfg: ArchConfig, lp, x, caches, i: int, pos):
    """One layer's decode attention on its caches (written in place)."""
    hh = rms_norm(x, lp["ln1"], cfg.norm_eps)
    if cfg.attention == "mla":
        lat, krp = caches
        a, _, _ = attn.mla_decode(lp["attn"], hh, lat[i], krp[i], pos,
                                  n_heads=cfg.n_heads, mla=cfg.mla,
                                  rope_theta=cfg.rope_theta)
    else:
        kc, vc = caches
        a, _, _ = attn.gqa_decode(
            lp["attn"], hh, kc[i], vc[i], pos, n_heads=cfg.n_heads,
            n_kv=cfg.n_kv_heads, hd=cfg.hd, rope_theta=cfg.rope_theta)
    return x + a


def decode_step(cfg: ArchConfig, params: Dict, cache: Dict,
                tokens: torch.Tensor):
    """One serve step: tokens (B, 1) -> (logits (B, 1, V), cache).

    The prefix layers (dense FFN), then the stack.  The token's K/V (MLA:
    latent and rope key) are written into the cache's tensors in place (the
    reference returns new arrays); the returned cache is a new dict with
    ``pos`` advanced by one.
    """
    check_supported(cfg)
    pos = cache["pos"]
    x = params["embed"][tokens.long()]
    mla = cfg.attention == "mla"
    for i, lp in enumerate(params.get("prefix_layers", [])):
        x = _decode_attn(cfg, lp, x, (cache["p_latent"], cache["p_krope"]),
                         i, pos)
        h = rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + ffn_mod.swiglu(lp["ffn"], h)
    caches = (cache["latent"], cache["krope"]) if mla \
        else (cache["k"], cache["v"])
    for i in range(caches[0].shape[0]):
        lp = layer_params(params, i)
        x = _decode_attn(cfg, lp, x, caches, i, pos)
        h = rms_norm(x, lp["ln2"], cfg.norm_eps)
        y, _ = _ffn_apply(cfg, lp, h)
        x = x + y
    h = rms_norm(x, params["out_norm"], cfg.norm_eps)
    logits = h @ params["lm_head"]
    return logits, {**cache, "pos": pos + 1}
