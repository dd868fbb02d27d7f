"""ArchConfig: one dataclass describing every supported architecture.

Counterpart of ``repro.configs.base``, field for field;
``activation_dtype`` returns a ``torch`` dtype.

Field semantics follow the assigned-architecture table (see DESIGN.md §5).
``block_pattern`` drives heterogeneous stacks: a string of block codes that
tiles the depth — 'A' attention+FFN, 'M' Mamba2, 'R' RWKV6, 'S' shared-
attention insert (zamba2), e.g. zamba2 = 'MMMMMS' repeating.
"""
from __future__ import annotations

import dataclasses
from typing import Literal, Optional

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 1
    d_ff_expert: int = 0
    n_shared: int = 0          # always-on shared experts (DeepSeek style)
    capacity_factor: float = 1.25
    router_dtype: str = "float32"
    impl: str = "gspmd"   # "shard_map" = explicit-collective EP (§Perf)


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Literal["dense", "moe", "ssm", "hybrid", "vlm", "audio"]
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None            # default d_model // n_heads
    attention: Literal["gqa", "mla", "none"] = "gqa"
    mla: Optional[MLAConfig] = None
    moe: Optional[MoEConfig] = None
    block_pattern: str = "A"                   # tiles over depth
    first_layer_dense_ffn: bool = False        # deepseek-v2 style
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    attn_p_dtype: str = "float32"   # "bfloat16" halves score HBM traffic
    # --- paper integration: TopK-SpGEMM FFN (Eq. 1-3) ---
    ffn_mode: Literal["dense", "topk", "block_topk"] = "dense"
    topk_k: int = 0                            # kept d_ff entries per token
    topk_block: int = 128                      # lanes per block (block_topk)
    # --- SSM blocks ---
    ssm_state: int = 64
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    rwkv_chunk: int = 32     # chunked parallel WKV (0 = per-token recurrence)
    shared_attn_every: int = 6                 # zamba2 shared block period
    sliding_window: int = 0                    # 0 = full causal
    # --- enc-dec / frontends ---
    encoder_layers: int = 0                    # >0 => enc-dec (whisper)
    encoder_seq: int = 1500                    # stub frame count
    frontend: Literal["none", "audio_stub", "vision_stub"] = "none"
    vision_patches: int = 256                  # stub patch count (vlm)
    dtype: str = "bfloat16"
    # train-time
    remat: Literal["none", "full"] = "full"
    remat_groups: int = 0   # >1 = sqrt-schedule nested-scan remat (§Perf lever)
    loss_chunks: int = 8
    # --- measurement mode (roofline accounting; see launch/dryrun.py) ---
    # XLA cost_analysis counts while-loop bodies ONCE (trip counts unknown to
    # it), so roofline measurement unrolls every loop on reduced-depth models
    # and extrapolates the per-layer marginal cost.  Production graphs keep
    # scan (depth-independent HLO / compile time).
    unroll_layers: bool = False
    unroll_inner: bool = False      # flash-attn chunks + loss chunks
    attn_chunk: int = 0             # override flash q/k chunk (measurement)

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def activation_dtype(self):
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    def pattern_at(self, layer: int) -> str:
        return self.block_pattern[layer % len(self.block_pattern)]

    def n_params(self) -> float:
        """Analytic parameter count (for 6·N·D roofline bookkeeping)."""
        d, v = self.d_model, self.vocab
        n = v * d  # embedding
        n += v * d  # lm head (untied)
        per_layer_attn = 0.0
        if self.attention == "gqa":
            hd = self.hd
            per_layer_attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
                + (self.n_heads * hd) * d
        elif self.attention == "mla":
            m = self.mla
            qd = self.n_heads * (m.qk_nope_dim + m.qk_rope_dim)
            per_layer_attn = d * qd + d * (m.kv_lora + m.qk_rope_dim) \
                + m.kv_lora * self.n_heads * (m.qk_nope_dim + m.v_head_dim) \
                + self.n_heads * m.v_head_dim * d
        def ffn_params(dff):
            return 3 * d * dff  # SwiGLU
        per_layer_ffn = ffn_params(self.d_ff)
        moe_active_ffn = per_layer_ffn
        if self.moe and self.moe.n_experts:
            e = self.moe
            per_layer_ffn = e.n_experts * ffn_params(e.d_ff_expert) \
                + e.n_shared * ffn_params(e.d_ff_expert) + self.d_model * e.n_experts
            moe_active_ffn = (e.top_k + e.n_shared) * ffn_params(e.d_ff_expert) \
                + self.d_model * e.n_experts
        ssm_per_layer = 0.0
        if "M" in self.block_pattern:
            di = self.ssm_expand * d
            heads = di // self.ssm_head_dim
            ssm_per_layer = d * 2 * di + di * self.ssm_conv \
                + di * 2 * self.ssm_state + heads + di * d
        rwkv_per_layer = 0.0
        if "R" in self.block_pattern:
            rwkv_per_layer = 4 * d * d + d * self.d_ff * 2 + 6 * d
        total_layers = self.n_layers + self.encoder_layers
        n_attn_layers = sum(
            1 for i in range(total_layers)
            if self.pattern_at(i) in ("A", "S") or self.encoder_layers
        ) if self.attention != "none" else 0
        n_ssm = sum(1 for i in range(self.n_layers) if self.pattern_at(i) == "M")
        n_rwkv = sum(1 for i in range(self.n_layers) if self.pattern_at(i) == "R")
        n_ffn = total_layers - n_ssm - n_rwkv
        n += n_attn_layers * per_layer_attn + n_ffn * per_layer_ffn
        n += n_ssm * ssm_per_layer + n_rwkv * rwkv_per_layer
        if self.encoder_layers:  # cross attention in decoder
            n += self.n_layers * per_layer_attn
        return float(n)

    def n_active_params(self) -> float:
        """Active (per-token) params for MoE 6·N_active·D accounting."""
        if not (self.moe and self.moe.n_experts):
            return self.n_params()
        d = self.d_model
        e = self.moe
        full_ffn = e.n_experts * 3 * d * e.d_ff_expert
        active_ffn = (e.top_k + e.n_shared) * 3 * d * e.d_ff_expert
        return self.n_params() - self.n_layers * (full_ffn - active_ffn)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPE_SETS = (
    ShapeSpec("train_4k", 4096, 256, "train"),
    ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    ShapeSpec("decode_32k", 32768, 128, "decode"),
    ShapeSpec("long_500k", 524288, 1, "decode"),
)
