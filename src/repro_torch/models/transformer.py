"""The LM backbone for the dense attention+FFN stack ('A' blocks, GQA/MHA).

Counterpart of ``repro.models.transformer`` for the configs of the dense
GQA family (phi3-mini, granite, deepseek-67b, internlm2).  Parameters are
plain dicts of tensors in the reference's tree, with the per-layer weights
stacked on a leading layer axis (``params["layers"]["attn"].wq`` is ``(L,
D, H*hd)``); the layers run as a Python loop where the reference scans.
Attention goes through ``models.attention`` and so, for a full-sequence
forward, through the fused flash kernel (K7).

Not ported yet (ROADMAP Queue A item 12): MLA, MoE, Mamba2 ('M') and RWKV6
('R') blocks, the whisper encoder and the vision/audio frontends; a config
that needs one raises ``NotImplementedError``.  ``param_specs`` (sharding)
waits for the multi-device slice.
"""
from __future__ import annotations

from typing import Dict, Mapping

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
    if cfg.attention != "gqa":
        missing.append("MLA attention" if cfg.attention == "mla"
                       else f"attention={cfg.attention!r}")
    if cfg.moe and cfg.moe.n_experts:
        missing.append("MoE FFN")
    if set(cfg.block_pattern) != {"A"}:
        missing.append(f"block pattern {cfg.block_pattern!r} (Mamba2/RWKV6)")
    if cfg.first_layer_dense_ffn:
        missing.append("a dense prefix layer")
    if cfg.encoder_layers:
        missing.append("the encoder and cross-attention")
    if cfg.frontend != "none":
        missing.append(f"the {cfg.frontend} frontend")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported yet "
            f"(ROADMAP Queue A item 12)")


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def init_transformer(cfg: ArchConfig, generator: torch.Generator,
                     device="cuda") -> Dict:
    """Random parameters from ``generator`` (drawn on its device), on
    ``device``: embedding N(0, 0.02²), projections N(0, 1/d_in), norms 1, as
    the reference draws them (not its numbers)."""
    check_supported(cfg)
    dtype = cfg.activation_dtype
    d, n = cfg.d_model, cfg.n_layers
    embed = torch.randn((cfg.vocab, d), generator=generator,
                        dtype=torch.float32, device=generator.device) * 0.02
    params = {
        "embed": embed.to(dtype),
        "out_norm": torch.ones((d,), dtype=dtype),
        "lm_head": dense_init(generator, d, cfg.vocab, dtype),
        "layers": {
            "ln1": torch.ones((n, d), dtype=dtype),
            "attn": attn.gqa_init(generator, d, cfg.n_heads, cfg.n_kv_heads,
                                  cfg.hd, dtype, layers=n),
            "ln2": torch.ones((n, d), dtype=dtype),
            "ffn": ffn_mod.ffn_init(generator, d, cfg.d_ff, dtype, layers=n),
        },
    }
    return _map(params, lambda t: t.to(device))


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(_map(v, fn) for v in tree))
    return fn(tree)


PARAM_KEYS = ("embed", "out_norm", "lm_head", "layers/ln1", "layers/attn/wq",
              "layers/attn/wk", "layers/attn/wv", "layers/attn/wo",
              "layers/ln2", "layers/ffn/w1", "layers/ffn/w3", "layers/ffn/w2")


def params_from_numpy(cfg: ArchConfig, flat: Mapping[str, np.ndarray],
                      device="cuda") -> Dict:
    """Parameters from host arrays keyed by the reference's tree paths
    (``"layers/attn/wq"``, layer axis first), bit for bit (bfloat16
    included, through ``sparse.formats.from_numpy``)."""
    check_supported(cfg)
    if set(flat) != set(PARAM_KEYS):
        raise ValueError(f"expected the keys {sorted(PARAM_KEYS)}, got "
                         f"{sorted(flat)}")

    def t(key):
        return from_numpy(flat[key], device)

    return {
        "embed": t("embed"), "out_norm": t("out_norm"),
        "lm_head": t("lm_head"),
        "layers": {
            "ln1": t("layers/ln1"),
            "attn": attn.AttnParams(*(t(f"layers/attn/{w}")
                                      for w in attn.AttnParams._fields)),
            "ln2": t("layers/ln2"),
            "ffn": ffn_mod.FFNParams(*(t(f"layers/ffn/{w}")
                                       for w in ffn_mod.FFNParams._fields)),
        },
    }


def layer_params(params: Dict, i: int) -> Dict:
    """Layer ``i``'s parameters (views into the stacked tensors)."""
    return _map(params["layers"], lambda a: a[i])


# ---------------------------------------------------------------------------
# Blocks (train/prefill)
# ---------------------------------------------------------------------------

def _ffn_apply(cfg: ArchConfig, lp, x):
    if cfg.ffn_mode == "topk" and cfg.topk_k:
        return ffn_mod.topk_ffn(lp["ffn"], x, cfg.topk_k)
    if cfg.ffn_mode == "block_topk" and cfg.topk_k:
        return ffn_mod.block_topk_ffn(lp["ffn"], x, cfg.topk_k,
                                      block=cfg.topk_block)
    return ffn_mod.swiglu(lp["ffn"], x)


def _attn_block(cfg: ArchConfig, lp, x):
    """Causal attention + FFN.  A dense-family config attends without a
    window (the reference passes ``sliding_window`` only to hybrids)."""
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    a = attn.gqa_forward(
        lp["attn"], h, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, hd=cfg.hd,
        rope_theta=cfg.rope_theta, causal=True, window=0,
        attn_chunk=cfg.attn_chunk,
        p_dtype=torch.bfloat16 if cfg.attn_p_dtype == "bfloat16" else None)
    x = x + a
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + _ffn_apply(cfg, lp, h)


def forward_hidden(cfg: ArchConfig, params: Dict, tokens: torch.Tensor):
    """tokens (B, S) -> (final hidden (B, S, D), aux loss).  The aux loss
    is MoE's and so 0 here."""
    check_supported(cfg)
    x = params["embed"][tokens.long()]
    for i in range(params["layers"]["ln1"].shape[0]):
        x = _attn_block(cfg, layer_params(params, i), x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return rms_norm(x, params["out_norm"], cfg.norm_eps), aux


def train_loss(cfg: ArchConfig, params: Dict, batch: Mapping) -> torch.Tensor:
    """batch: {"tokens": (B, S), "labels": (B, S)} -> mean next-token loss.
    On the card, call it under ``torch.no_grad()``: the flash kernel has no
    backward yet."""
    h, aux = forward_hidden(cfg, params, batch["tokens"])
    loss = cross_entropy_chunked(lambda hh, w: hh @ w, h, batch["labels"],
                                 params["lm_head"], cfg.loss_chunks)
    return loss + 0.01 * aux


# ---------------------------------------------------------------------------
# Decode (serve step)
# ---------------------------------------------------------------------------

def init_decode_cache(cfg: ArchConfig, batch: int, max_seq: int, dtype=None,
                      device="cuda") -> Dict:
    """KV caches stacked on a leading per-layer axis, and one shared
    position ``pos`` (a 0-d int32 tensor) for the whole batch."""
    check_supported(cfg)
    dtype = dtype or cfg.activation_dtype
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.hd)
    return {"pos": torch.zeros((), dtype=torch.int32, device=device),
            "k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_step(cfg: ArchConfig, params: Dict, cache: Dict,
                tokens: torch.Tensor):
    """One serve step: tokens (B, 1) -> (logits (B, 1, V), cache).

    The token's K/V are written into the cache's tensors in place (the
    reference returns new arrays); the returned cache is a new dict with
    ``pos`` advanced by one.
    """
    check_supported(cfg)
    pos = cache["pos"]
    x = params["embed"][tokens.long()]
    for i in range(cache["k"].shape[0]):
        lp = layer_params(params, i)
        hh = rms_norm(x, lp["ln1"], cfg.norm_eps)
        a, _, _ = attn.gqa_decode(
            lp["attn"], hh, cache["k"][i], cache["v"][i], pos,
            n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, hd=cfg.hd,
            rope_theta=cfg.rope_theta)
        x = x + a
        h = rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + _ffn_apply(cfg, lp, h)
    h = rms_norm(x, params["out_norm"], cfg.norm_eps)
    logits = h @ params["lm_head"]
    return logits, {**cache, "pos": pos + 1}
