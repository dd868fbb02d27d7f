"""The LM backbone: every configuration's stack, one block kind a config.

Counterpart of ``repro.models.transformer``.  Block kinds: 'A' attention +
FFN (GQA/MHA or MLA attention, dense or MoE FFN, DeepSeek-V2's dense prefix
layer; Whisper's decoder layers add cross-attention to an encoder stack
over stub frame embeddings), 'M' Mamba2 (Zamba2: one weight-shared
attention + FFN block after every ``shared_attn_every`` layers, attending
through a ``sliding_window``), 'R' RWKV6 (attention-free).  InternVL2's
vision stub writes patch embeddings over the first token positions.
Parameters are plain dicts of tensors in the reference's tree, with the
per-layer weights stacked on a leading layer axis
(``params["layers"]["attn"].wq`` is ``(L, D, H*hd)``), a dense prefix layer
as ``params["prefix_layers"][0]``, Zamba2's ``shared_attn`` unstacked and
Whisper's ``encoder`` stacked; the layers run as a Python loop where the
reference scans.  Attention goes through ``models.attention`` and so, for a
full-sequence forward, through the fused flash kernel (K7): causal, MLA's
expanded prefill, the shared block's window, the encoder's unmasked
attention and the decoder's cross-attention.  The Mamba2 SSD and the RWKV6
WKV are plain PyTorch, as the reference leaves them to XLA.

Under a mesh the parameters are DTensors placed by ``param_specs``
(Megatron-style tensor parallelism over ``model``, experts over ``model``)
and ``sh`` (``launch.sharding.Shardings``) constrains the activations at
the reference's points; ``UNSHARDED`` makes every constraint a counted
no-op.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, List, Mapping, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.sharding import (P, Shardings, UNSHARDED,
                                         replicating, unsplit)
from repro_torch.models import attention as attn
from repro_torch.models import ffn as ffn_mod
from repro_torch.models import mamba2 as m2
from repro_torch.models import rwkv6 as rk
from repro_torch.models.common import (cross_entropy_chunked, dense_init,
                                       residual, rms_norm)
from repro_torch.sparse.formats import from_numpy


class Transformer(NamedTuple):
    """A config and its parameter tree."""
    cfg: ArchConfig
    params: Dict[str, Any]


def block_kind(cfg: ArchConfig) -> str:
    """The block code of the stack: 'A', 'M' or 'R'."""
    return cfg.block_pattern[0]


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for a mixed block pattern: the
    reference runs one as all 'A', and no config has one."""
    if len(set(cfg.block_pattern)) != 1 or block_kind(cfg) not in "AMR":
        raise NotImplementedError(
            f"{cfg.name}: block pattern {cfg.block_pattern!r}; the port runs "
            f"one block kind a stack ('A', 'M' or 'R')")


@dataclasses.dataclass(frozen=True)
class Segment:
    """A span of Mamba2 layers, and whether the shared block follows it."""
    start: int
    length: int
    shared_after: bool


def segments(cfg: ArchConfig) -> List[Segment]:
    """Zamba2's spans of ``shared_attn_every`` layers, the shared block
    after each full one; one span for any other stack."""
    if cfg.block_pattern == "M" and cfg.shared_attn_every:
        segs, i = [], 0
        while i < cfg.n_layers:
            ln = min(cfg.shared_attn_every, cfg.n_layers - i)
            segs.append(Segment(i, ln, ln == cfg.shared_attn_every))
            i += ln
        return segs
    return [Segment(0, cfg.n_layers, False)]


def n_shared_apps(cfg: ArchConfig) -> int:
    """How many times the shared block runs in one forward."""
    return sum(1 for s in segments(cfg) if s.shared_after)


def has_shared_attn(cfg: ArchConfig) -> bool:
    return cfg.block_pattern == "M" and bool(cfg.shared_attn_every)


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


def _attn_layer_init(cfg: ArchConfig, generator, device, layers=None,
                     cross: bool = False) -> Dict:
    """An attention + FFN layer (stacked for ``layers``): ln1, attn,
    (ln_cross, cross,) ln2, ffn, on ``device``."""
    dtype, d = cfg.activation_dtype, cfg.d_model
    norm = (d,) if layers is None else (layers, d)
    lp = {"ln1": torch.ones(norm, dtype=dtype),
          "attn": _attn_init(cfg, generator, layers=layers)}
    if cross:
        lp["ln_cross"] = torch.ones(norm, dtype=dtype)
        lp["cross"] = attn.gqa_init(generator, d, cfg.n_heads,
                                    cfg.n_kv_heads, cfg.hd, dtype,
                                    layers=layers)
    lp["ln2"] = torch.ones(norm, dtype=dtype)
    lp = _map(lp, lambda t: t.to(device))
    if is_moe(cfg):
        lp["ffn"] = ffn_mod.moe_init(generator, d, cfg.moe, dtype,
                                     layers=layers, device=device)
    else:
        lp["ffn"] = _map(ffn_mod.ffn_init(generator, d, cfg.d_ff, dtype,
                                          layers=layers),
                         lambda t: t.to(device))
    return lp


def init_transformer(cfg: ArchConfig, generator: torch.Generator,
                     device="cuda") -> Dict:
    """Random parameters from ``generator`` (drawn on its device), on
    ``device``: embedding N(0, 0.02²), projections N(0, 1/d_in), a MoE
    router in float32, norms 1, and the Mamba2 and RWKV6 blocks' own
    constants, as the reference draws them (not its numbers).  MoE layers
    are drawn and placed one at a time."""
    check_supported(cfg)
    dtype = cfg.activation_dtype
    d, n = cfg.d_model, cfg.n_layers - n_prefix(cfg)
    embed = torch.randn((cfg.vocab, d), generator=generator,
                        dtype=torch.float32, device=generator.device) * 0.02
    params = _map({
        "embed": embed.to(dtype),
        "out_norm": torch.ones((d,), dtype=dtype),
        "lm_head": dense_init(generator, d, cfg.vocab, dtype),
    }, lambda t: t.to(device))
    del embed
    kind = block_kind(cfg)
    if kind == "M":
        params["layers"] = _map({
            "ln1": torch.ones((n, d), dtype=dtype),
            "mamba": m2.mamba2_init(
                generator, d, expand=cfg.ssm_expand,
                head_dim=cfg.ssm_head_dim, state=cfg.ssm_state,
                conv=cfg.ssm_conv, dtype=dtype, layers=n),
        }, lambda t: t.to(device))
    elif kind == "R":
        params["layers"] = _map({
            "ln1": torch.ones((n, d), dtype=dtype),
            "ln2": torch.ones((n, d), dtype=dtype),
            "rwkv": rk.rwkv6_init(generator, d, cfg.d_ff, cfg.n_heads, dtype,
                                  layers=n),
        }, lambda t: t.to(device))
    else:
        params["layers"] = _attn_layer_init(
            cfg, generator, device, layers=n, cross=cfg.encoder_layers > 0)
    if has_shared_attn(cfg):
        params["shared_attn"] = _attn_layer_init(cfg, generator, device)
    if cfg.encoder_layers:
        params["encoder"] = _attn_layer_init(cfg, generator, device,
                                             layers=cfg.encoder_layers)
        params["enc_norm"] = torch.ones((d,), dtype=dtype, device=device)
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


def _tree(cfg: ArchConfig, get: Callable[[str], object]) -> Dict:
    """The reference's parameter tree of ``cfg`` with each leaf
    ``get(path)``, ``path`` its tree path (``"layers/attn/wq"``; a list's
    index is a path element, ``"prefix_layers/0/ln1"``)."""
    def nt(cls, prefix):
        return cls(*(get(f"{prefix}/{w}") for w in cls._fields))

    def ffn(prefix, dense=False):
        if is_moe(cfg) and not dense:
            return ffn_mod.MoEParams(
                *(get(f"{prefix}/{w}") for w in ("router", "w1", "w3", "w2")),
                nt(ffn_mod.FFNParams, f"{prefix}/shared")
                if cfg.moe.n_shared else None)
        return nt(ffn_mod.FFNParams, prefix)

    def attn_layer(prefix, cross=False, dense=False):
        lp = {"ln1": get(f"{prefix}/ln1"),
              "attn": nt(_attn_cls(cfg), f"{prefix}/attn")}
        if cross:
            lp["ln_cross"] = get(f"{prefix}/ln_cross")
            lp["cross"] = nt(attn.AttnParams, f"{prefix}/cross")
        lp["ln2"] = get(f"{prefix}/ln2")
        lp["ffn"] = ffn(f"{prefix}/ffn", dense)
        return lp

    tree = {"embed": get("embed"), "out_norm": get("out_norm"),
            "lm_head": get("lm_head")}
    kind = block_kind(cfg)
    if kind == "M":
        tree["layers"] = {"ln1": get("layers/ln1"),
                          "mamba": nt(m2.Mamba2Params, "layers/mamba")}
    elif kind == "R":
        tree["layers"] = {"ln1": get("layers/ln1"), "ln2": get("layers/ln2"),
                          "rwkv": nt(rk.RWKV6Params, "layers/rwkv")}
    else:
        tree["layers"] = attn_layer("layers", cross=cfg.encoder_layers > 0)
    if n_prefix(cfg):
        tree["prefix_layers"] = [attn_layer(f"prefix_layers/{i}", dense=True)
                                 for i in range(n_prefix(cfg))]
    if has_shared_attn(cfg):
        tree["shared_attn"] = attn_layer("shared_attn")
    if cfg.encoder_layers:
        tree["encoder"] = attn_layer("encoder")
        tree["enc_norm"] = get("enc_norm")
    return tree


def param_keys(cfg: ArchConfig) -> List[str]:
    """The reference's tree paths of ``cfg``'s parameters, layer axis first
    under ``layers/`` and ``encoder/``; a list's index is a path element
    (``prefix_layers/0/attn/wq``)."""
    keys: List[str] = []
    _tree(cfg, keys.append)
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
    return _tree(cfg, lambda key: from_numpy(flat[key], device))


def flat_params(params: Dict) -> Dict[str, torch.Tensor]:
    """The parameter tree as ``{tree path: tensor}``, the paths of
    ``param_keys`` (the tensors themselves, not copies)."""
    flat: Dict[str, torch.Tensor] = {}

    def walk(t, prefix):
        if t is None:
            return
        if isinstance(t, dict):
            items = t.items()
        elif isinstance(t, tuple) and hasattr(t, "_fields"):
            items = ((f, getattr(t, f)) for f in t._fields)
        elif isinstance(t, list):
            items = enumerate(t)
        else:
            flat[prefix] = t
            return
        for key, sub in items:
            walk(sub, f"{prefix}/{key}" if prefix else str(key))

    walk(params, "")
    return flat


def tree_params(cfg: ArchConfig, flat: Mapping[str, torch.Tensor]) -> Dict:
    """The parameter tree of ``cfg`` from ``{tree path: tensor}``, the
    inverse of ``flat_params``."""
    return _tree(cfg, flat.__getitem__)


@functools.lru_cache(maxsize=None)
def param_shapes(cfg: ArchConfig) -> Dict[str, Tuple[Tuple[int, ...],
                                                   torch.dtype]]:
    """``{tree path: (shape, dtype)}`` of ``cfg``'s parameters, from
    ``init_transformer`` traced under ``FakeTensorMode``: nothing is
    allocated and no number is drawn."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        fake = init_transformer(cfg, torch.Generator(device="cpu"), "cpu")
        return {k: (tuple(t.shape), t.dtype)
                for k, t in flat_params(fake).items()}


_COL = {"wq", "wk", "wv", "w1", "w3", "ck", "w_uk", "w_uv", "in_proj",
        "lm_head", "wr", "wk2", "wg", "router"}
_ROW = {"wo", "w2", "cv", "out_proj", "cr"}


def _spec_for(path: str, shape: Tuple[int, ...], model_size: int) -> P:
    """Tensor-parallel rules by parameter name: column-parallel weights
    split their output dim over ``model``, row-parallel ones (down and out
    projections) their input dim; only dims that ``model_size`` divides."""
    def ok(dim):
        return dim % model_size == 0 if model_size > 1 else False

    last = path.split("/")[-1]
    if last == "embed":
        return P("model" if ok(shape[0]) else None, None)
    if last in _COL:
        return P(*([None] * (len(shape) - 1)),
                 "model" if ok(shape[-1]) else None)
    if last in _ROW:
        spec = [None] * len(shape)
        if ok(shape[-2] if len(shape) >= 2 else shape[0]):
            spec[-2] = "model"
        return P(*spec)
    return P(*([None] * len(shape)))


def _moe_spec(path: str, shape, model_size):
    """Experts (the dim after the layer axis) on ``model``: expert
    parallelism; None when ``model_size`` does not divide them."""
    if path.split("/")[-1] in ("w1", "w3", "w2") and len(shape) >= 3:
        e_dim = len(shape) - 3
        if shape[e_dim] % model_size == 0 and shape[e_dim] >= model_size:
            spec = [None] * len(shape)
            spec[e_dim] = "model"
            return P(*spec)
    return None


def param_specs(cfg: ArchConfig, params, model_size: int = 16) -> Dict:
    """The spec of every parameter, in the tree of ``params`` (any tree of
    ``cfg``'s parameters whose leaves have ``.shape``: tensors, meta
    tensors, ``launch.specs.ShapeDtypeStruct``s)."""
    moe = is_moe(cfg)

    def one(path):
        shape = tuple(lookup[path].shape)
        if moe and "layers" in path and "ffn" in path \
                and "shared" not in path:
            s = _moe_spec(path, shape, model_size)
            if s is not None:
                return s
        base = _spec_for(path, shape, model_size)
        # stacked layers: the layer axis is never split
        if path.startswith(("layers", "encoder")) and len(base) < len(shape):
            return P(*([None] * (len(shape) - len(base))), *base)
        return base

    lookup = flat_params(params)
    return _tree(cfg, one)


def layer_params(params: Dict, i: int) -> Dict:
    """Layer ``i``'s parameters (views into the stacked tensors)."""
    return _map(params["layers"], lambda a: a[i])


def unstack(tree) -> List[Dict]:
    """Every layer's parameters of a stacked tree (views), through one
    ``unbind`` a leaf.  Under autograd the gradient of an ``unbind`` is one
    ``stack`` of the layers' gradients, where indexing each layer apart
    (``layer_params``) would give each layer's gradient as a zero-filled
    tensor of the whole stack, summed one by one."""
    cols: List[tuple] = []
    _map(tree, lambda a: cols.append(a.unbind(0)))
    layers = []
    for i in range(len(cols[0])):
        it = iter(cols)
        layers.append(_map(tree, lambda a: next(it)[i]))
    return layers


# ---------------------------------------------------------------------------
# Blocks (train/prefill)
# ---------------------------------------------------------------------------

def embed_tokens(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """The rows of ``table`` (V, D) at ``tokens``.  A DTensor table split
    over its vocab is gathered first: DTensor's vocab-parallel lookup has
    no backward between its two kinds of partial sums, and its indexing
    backward (``index_put``) loses its placement on some torch versions,
    so the lookup is ``F.embedding`` on a table whole on every rank."""
    return F.embedding(tokens.long(), unsplit(table, 0))


def _ffn_apply(cfg: ArchConfig, lp, x, sh: Shardings = UNSHARDED):
    """The layer's FFN: (y, aux), aux the MoE's load-balance loss or 0.
    Under a mesh a MoE layer takes ``moe_ffn_shard_map`` (with
    ``moe.impl="shard_map"``); the port has no GSPMD to split ``moe_ffn``'s
    data-dependent dispatch, so a DTensor reaching it raises."""
    if isinstance(lp["ffn"], ffn_mod.MoEParams):
        if cfg.moe.impl == "shard_map" and sh.mesh is not None:
            return ffn_mod.moe_ffn_shard_map(lp["ffn"], x, cfg.moe, sh)
        if isinstance(x, DTensor):
            raise NotImplementedError(
                f"{cfg.name}: a MoE layer under a mesh runs "
                f"moe.impl='shard_map' (got {cfg.moe.impl!r})")
        return ffn_mod.moe_ffn(lp["ffn"], x, cfg.moe, sh=sh)
    if cfg.ffn_mode == "topk" and cfg.topk_k:
        return ffn_mod.topk_ffn(lp["ffn"], x, cfg.topk_k, sh=sh), 0.0
    if cfg.ffn_mode == "block_topk" and cfg.topk_k:
        return ffn_mod.block_topk_ffn(lp["ffn"], x, cfg.topk_k,
                                      block=cfg.topk_block, sh=sh), 0.0
    return ffn_mod.swiglu(lp["ffn"], x, sh=sh), 0.0


def _attn_block(cfg: ArchConfig, lp, x, sh: Shardings = UNSHARDED, *,
                causal: bool = True, window: int = 0, enc=None,
                dense_ffn: bool = False):
    """Attention + FFN: (x, aux).  ``window`` is the hybrid's sliding window
    (the reference passes ``sliding_window`` only to hybrids); with the
    encoder's output ``enc`` a layer that has ``cross`` attends to it after
    its self-attention; ``dense_ffn`` is the prefix layer's SwiGLU."""
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    p_dtype = torch.bfloat16 if cfg.attn_p_dtype == "bfloat16" else None
    if cfg.attention == "mla":
        a = attn.mla_forward(lp["attn"], h, n_heads=cfg.n_heads, mla=cfg.mla,
                             rope_theta=cfg.rope_theta, sh=sh,
                             attn_chunk=cfg.attn_chunk, p_dtype=p_dtype)
    else:
        a = attn.gqa_forward(
            lp["attn"], h, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
            hd=cfg.hd, rope_theta=cfg.rope_theta, causal=causal,
            window=window, sh=sh, attn_chunk=cfg.attn_chunk,
            p_dtype=p_dtype)
    x = residual(x, a)
    if enc is not None and "cross" in lp:
        h = rms_norm(x, lp["ln_cross"], cfg.norm_eps)
        kv = attn.gqa_cross_kv(lp["cross"], enc, cfg.n_kv_heads, cfg.hd)
        x = residual(x, attn.gqa_forward(
            lp["cross"], h, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
            hd=cfg.hd, rope_theta=cfg.rope_theta, sh=sh, cross_kv=kv,
            attn_chunk=cfg.attn_chunk, p_dtype=p_dtype))
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    if dense_ffn:
        return residual(x, ffn_mod.swiglu(lp["ffn"], h, sh=sh)), 0.0
    y, aux = _ffn_apply(cfg, lp, h, sh)
    return residual(x, y), aux


def _mamba_block(cfg: ArchConfig, lp, x):
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    return residual(x, m2.mamba2_forward(
        lp["mamba"], h, expand=cfg.ssm_expand, head_dim=cfg.ssm_head_dim,
        state=cfg.ssm_state, conv=cfg.ssm_conv))


def _rwkv_block(cfg: ArchConfig, lp, x):
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    y, _, _ = rk.rwkv6_time_mix(lp["rwkv"], h, n_heads=cfg.n_heads,
                                chunk=cfg.rwkv_chunk)
    x = residual(x, y)
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    y, _ = rk.rwkv6_channel_mix(lp["rwkv"], h)
    return residual(x, y)


def encode(cfg: ArchConfig, params: Dict, frames: torch.Tensor,
           sh: Shardings = UNSHARDED):
    """Whisper's encoder over stub frame embeddings (B, T_enc, D): each
    layer's attention unmasked (through K7), then ``enc_norm``."""
    x = frames.to(cfg.activation_dtype)
    for lp in unstack(params["encoder"]):
        x, _ = _attn_block(cfg, lp, x, sh, causal=False)
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


def forward_hidden(cfg: ArchConfig, params: Dict, tokens: torch.Tensor,
                   sh: Shardings = UNSHARDED, vision_embeds=None,
                   frames=None):
    """tokens (B, S) -> (final hidden (B, S, D), aux loss).

    The vision stub writes ``vision_embeds`` (B, P, D) over the first P
    positions; the encoder runs only when ``frames`` is given (a Whisper
    call without frames skips cross-attention, as the reference's does).
    Then the prefix layers with their dense FFN, and the stack: for Mamba2
    its segments with the shared block after each full one.  aux sums the
    MoE layers' load-balance losses in layer order (0 without MoE).
    ``sh`` constrains the activations between blocks (the reference's
    scan body) and inside them; under a mesh the parameters and ``tokens``
    are DTensors."""
    check_supported(cfg)
    with replicating(sh):
        x = embed_tokens(params["embed"], tokens)
        if cfg.frontend == "vision_stub" and vision_embeds is not None:
            x[:, :vision_embeds.shape[1]] = vision_embeds.to(x.dtype)
        enc = None
        if cfg.encoder_layers and frames is not None:
            enc = encode(cfg, params, frames, sh)
        x = sh.act_btd(x)
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        for lp in params.get("prefix_layers", []):
            x, aux = _attn_block(cfg, lp, x, sh, enc=enc, dense_ffn=True)
            aux_total = aux_total + aux
        kind = block_kind(cfg)
        layers = unstack(params["layers"])
        if kind == "A":
            window = cfg.sliding_window if cfg.family == "hybrid" else 0
            for lp in layers:
                x, aux = _attn_block(cfg, lp, sh.act_btd(x), sh,
                                     window=window, enc=enc)
                aux_total = aux_total + aux
        for seg in segments(cfg) if kind != "A" else ():
            for i in range(seg.start, seg.start + seg.length):
                block = _mamba_block if kind == "M" else _rwkv_block
                x = block(cfg, layers[i], sh.act_btd(x))
            if seg.shared_after:
                x, aux = _attn_block(cfg, params["shared_attn"], x, sh,
                                     window=cfg.sliding_window)
                aux_total = aux_total + aux
        return rms_norm(x, params["out_norm"], cfg.norm_eps), aux_total


def train_loss(cfg: ArchConfig, params: Dict, batch: Mapping,
               sh: Shardings = UNSHARDED) -> torch.Tensor:
    """batch: {"tokens": (B, S), "labels": (B, S)}, and the stub inputs
    ``"vision_embeds"`` and ``"frames"`` where the config has them -> mean
    next-token loss plus 0.01 × the MoE aux loss.  Differentiable on both
    devices: on the card its attention's gradient is K7's backward kernel.
    Under a mesh (``sh``) the loss is a replicated DTensor."""
    h, aux = forward_hidden(cfg, params, batch["tokens"], sh,
                            vision_embeds=batch.get("vision_embeds"),
                            frames=batch.get("frames"))
    with replicating(sh):
        loss = cross_entropy_chunked(lambda hh, w: sh.act_btv(hh @ w), h,
                                     batch["labels"], params["lm_head"],
                                     cfg.loss_chunks)
        return loss + 0.01 * aux


# ---------------------------------------------------------------------------
# Decode (serve step)
# ---------------------------------------------------------------------------

def init_decode_cache(cfg: ArchConfig, batch: int, max_seq: int, dtype=None,
                      device="cuda") -> Dict:
    """Caches stacked on a leading per-layer axis, and one shared position
    ``pos`` (a 0-d int32 tensor) for the whole batch: K/V for GQA; for MLA
    the latent and the rope key, ``p_latent``/``p_krope`` for the prefix
    layers; Whisper's ``cross_k``/``cross_v`` over the encoder's frames
    (zeros until filled); Mamba2's ``ssm`` state (float32) and ``conv``
    window, with ``shared_k``/``shared_v`` for each application of the
    shared block; RWKV6's ``wkv`` state (float32) and ``shift1``/``shift2``
    token-shift carries."""
    check_supported(cfg)
    dtype = dtype or cfg.activation_dtype
    n = cfg.n_layers - n_prefix(cfg)
    cache = {"pos": torch.zeros((), dtype=torch.int32, device=device)}

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    kind = block_kind(cfg)
    kv, hd = cfg.n_kv_heads, cfg.hd
    if kind == "M":
        di, heads = m2.mamba2_dims(cfg.d_model, cfg.ssm_expand,
                                   cfg.ssm_head_dim, cfg.ssm_state)
        cache["ssm"] = zeros(n, batch, heads, cfg.ssm_head_dim,
                             cfg.ssm_state, dt=torch.float32)
        cache["conv"] = zeros(n, batch, cfg.ssm_conv - 1,
                              di + 2 * cfg.ssm_state)
        if has_shared_attn(cfg):
            cache["shared_k"] = zeros(n_shared_apps(cfg), batch, max_seq, kv,
                                      hd)
            cache["shared_v"] = torch.zeros_like(cache["shared_k"])
    elif kind == "R":
        hp = cfg.d_model // cfg.n_heads
        cache["wkv"] = zeros(n, batch, cfg.n_heads, hp, hp, dt=torch.float32)
        cache["shift1"] = zeros(n, batch, cfg.d_model)
        cache["shift2"] = zeros(n, batch, cfg.d_model)
    elif cfg.attention == "mla":
        m = cfg.mla
        cache["latent"] = zeros(n, batch, max_seq, m.kv_lora)
        cache["krope"] = zeros(n, batch, max_seq, m.qk_rope_dim)
        if n_prefix(cfg):
            cache["p_latent"] = zeros(n_prefix(cfg), batch, max_seq,
                                      m.kv_lora)
            cache["p_krope"] = zeros(n_prefix(cfg), batch, max_seq,
                                     m.qk_rope_dim)
    else:
        cache["k"] = zeros(n, batch, max_seq, kv, hd)
        cache["v"] = zeros(n, batch, max_seq, kv, hd)
        if cfg.encoder_layers:
            cache["cross_k"] = zeros(n, batch, cfg.encoder_seq, kv, hd)
            cache["cross_v"] = torch.zeros_like(cache["cross_k"])
    return cache


def _decode_attn(cfg: ArchConfig, lp, x, caches, i: int, pos, window=0):
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
            n_kv=cfg.n_kv_heads, hd=cfg.hd, rope_theta=cfg.rope_theta,
            window=window)
    return residual(x, a)


def _decode_cross(cfg: ArchConfig, lp, x, ck, cv):
    """Whisper's cross-attention of one token over the encoder's K/V
    caches, all of them (no rope on q, as in the reference)."""
    hh = rms_norm(x, lp["ln_cross"], cfg.norm_eps)
    b = hh.shape[0]
    q = (hh @ lp["cross"].wq).reshape(b, 1, cfg.n_heads, cfg.hd)
    o = attn.decode_attention(q, ck, cv, ck.shape[1])
    return x + o.reshape(b, 1, cfg.n_heads * cfg.hd) @ lp["cross"].wo


def _decode_ffn(cfg: ArchConfig, lp, x, sh: Shardings = UNSHARDED,
                dense_ffn: bool = False):
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    if dense_ffn:
        return residual(x, ffn_mod.swiglu(lp["ffn"], h, sh=sh))
    y, _ = _ffn_apply(cfg, lp, h, sh)
    return residual(x, y)


def decode_step(cfg: ArchConfig, params: Dict, cache: Dict,
                tokens: torch.Tensor, sh: Shardings = UNSHARDED):
    """One serve step: tokens (B, 1) -> (logits (B, 1, V), cache).

    The prefix layers (dense FFN), then the stack: attention layers (with
    cross-attention over ``cross_k``/``cross_v`` for Whisper), Mamba2
    segments with the shared block's windowed attention after each full
    one, or RWKV6 layers.  Every cache is written in place (the reference
    returns new arrays); the returned cache is a new dict with ``pos``
    advanced by one.
    """
    check_supported(cfg)
    with replicating(sh):
        return _decode_step(cfg, params, cache, tokens, sh)


def _decode_step(cfg: ArchConfig, params: Dict, cache: Dict, tokens, sh):
    pos = cache["pos"]
    x = sh.act_btd(embed_tokens(params["embed"], tokens))
    for i, lp in enumerate(params.get("prefix_layers", [])):
        x = _decode_attn(cfg, lp, x, (cache["p_latent"], cache["p_krope"]),
                         i, pos)
        x = _decode_ffn(cfg, lp, x, sh, dense_ffn=True)
    kind = block_kind(cfg)
    if kind == "A":
        caches = (cache["latent"], cache["krope"]) \
            if cfg.attention == "mla" else (cache["k"], cache["v"])
        for i in range(caches[0].shape[0]):
            lp = layer_params(params, i)
            x = _decode_attn(cfg, lp, x, caches, i, pos)
            if "cross_k" in cache:
                x = _decode_cross(cfg, lp, x, cache["cross_k"][i],
                                  cache["cross_v"][i])
            x = _decode_ffn(cfg, lp, x, sh)
    elif kind == "M":
        app = 0
        for seg in segments(cfg):
            for i in range(seg.start, seg.start + seg.length):
                lp = layer_params(params, i)
                hh = rms_norm(x, lp["ln1"], cfg.norm_eps)
                y, ssm, conv = m2.mamba2_decode(
                    lp["mamba"], hh, cache["ssm"][i], cache["conv"][i],
                    expand=cfg.ssm_expand, head_dim=cfg.ssm_head_dim,
                    state=cfg.ssm_state, conv=cfg.ssm_conv)
                cache["ssm"][i].copy_(ssm)
                cache["conv"][i].copy_(conv)
                x = x + y
            if seg.shared_after:
                lp = params["shared_attn"]
                x = _decode_attn(cfg, lp, x,
                                 (cache["shared_k"], cache["shared_v"]), app,
                                 pos, window=cfg.sliding_window)
                x = _decode_ffn(cfg, lp, x, sh)
                app += 1
    else:
        for i in range(cache["wkv"].shape[0]):
            lp = layer_params(params, i)
            hh = rms_norm(x, lp["ln1"], cfg.norm_eps)
            y, wkv, last1 = rk.rwkv6_time_mix(
                lp["rwkv"], hh, n_heads=cfg.n_heads, state=cache["wkv"][i],
                x_prev=cache["shift1"][i])
            x = x + y
            hh = rms_norm(x, lp["ln2"], cfg.norm_eps)
            y, last2 = rk.rwkv6_channel_mix(lp["rwkv"], hh,
                                            x_prev=cache["shift2"][i])
            x = x + y
            cache["wkv"][i].copy_(wkv)
            cache["shift1"][i].copy_(last1)
            cache["shift2"][i].copy_(last2)
    h = rms_norm(x, params["out_norm"], cfg.norm_eps)
    logits = sh.act_btv(h @ params["lm_head"])
    return logits, {**cache, "pos": pos + 1}
