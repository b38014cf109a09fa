"""Model configuration for the unified decoder stack (reference:
``repro/models/config.py``), with the same fields and properties.

One ``ModelConfig`` describes any of the 10 assigned architectures; a
*layer pattern* of period ``p`` is repeated ``n_layers / p`` times and
parameters are stored stacked per pattern position with a leading
``repeat`` dim. ``act_dtype`` is a torch dtype here.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Literal

import torch

AttnKind = Literal["full", "swa", "mamba", "rwkv"]
MlpKind = Literal["dense", "moe"]


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int                      # per-expert hidden
    capacity_factor: float = 1.25
    router: Literal["linear", "balanced_kmeans"] = "linear"
    router_d_eff: int = 8          # effective dim for influence Eq. (1)
    router_influence_clip: float = 0.05
    n_shared_experts: int = 0      # llama4-style shared expert
    dispatch_no_repeat: bool = False   # gather tokens via idx//K instead of
    #                                    a K-times-repeated source


@dataclass(frozen=True)
class LayerSpec:
    attn: AttnKind = "full"
    mlp: MlpKind = "dense"


@dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None            # default d_model // n_heads
    pattern: tuple = (LayerSpec(),)  # repeated n_layers/len(pattern) times
    mlp_kind: Literal["swiglu", "gelu"] = "swiglu"
    moe: MoEConfig | None = None
    window: int = 1024                     # swa window
    swa_ring_cache: bool = False           # window-sized ring decode cache
    rope_theta: float = 10_000.0
    rope_theta_global: float | None = None  # gemma3: different global theta
    logit_softcap: float | None = None
    input_mode: Literal["tokens", "embeddings", "codebooks"] = "tokens"
    n_codebooks: int = 1                   # musicgen
    tie_embeddings: bool = False
    # mamba
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    # rwkv
    rwkv_head_dim: int = 64
    rwkv_lora_rank: int = 64
    # numerics
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    moment_dtype: str = "float32"          # optimizer moments (bf16 for 400B)
    # misc hints
    seq_len_hint: int | None = None
    norm_eps: float = 1e-6

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def period(self) -> int:
        return len(self.pattern)

    @property
    def n_repeats(self) -> int:
        assert self.n_layers % self.period == 0
        return self.n_layers // self.period

    @property
    def vocab_padded(self) -> int:
        return -(-self.vocab_size // 128) * 128  # pad to 128 lanes

    @property
    def act_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def param_count(self) -> int:
        """Analytic parameter count (excludes biases we don't use)."""
        d, hd = self.d_model, self.hd
        n = self.vocab_padded * d  # embed
        if not self.tie_embeddings:
            n += self.vocab_padded * d * (self.n_codebooks if
                                          self.input_mode == "codebooks" else 1)
        per_pattern = 0
        for spec in self.pattern:
            if spec.attn in ("full", "swa"):
                per_pattern += d * (self.n_heads * hd) + \
                    2 * d * (self.n_kv_heads * hd) + (self.n_heads * hd) * d
            elif spec.attn == "mamba":
                di = self.mamba_expand * d
                dt_rank = max(d // 16, 1)
                per_pattern += d * 2 * di + di * self.mamba_d_conv + \
                    di * (dt_rank + 2 * self.mamba_d_state) + dt_rank * di + \
                    di * self.mamba_d_state + di + di * d
            elif spec.attn == "rwkv":
                per_pattern += 4 * d * d + d * d  # r,k,v,g,o
                per_pattern += 2 * d * self.rwkv_lora_rank
            if spec.mlp == "dense":
                mult = 3 if self.mlp_kind == "swiglu" else 2
                per_pattern += mult * d * self.d_ff
            elif spec.mlp == "moe":
                m = self.moe
                mult = 3
                per_pattern += m.n_experts * mult * d * m.d_ff
                per_pattern += d * m.n_experts  # router
                per_pattern += m.n_shared_experts * mult * d * m.d_ff
        n += per_pattern * self.n_repeats
        return n

    def active_param_count(self) -> int:
        """Per-token active params (MoE: only top_k experts)."""
        if self.moe is None:
            return self.param_count()
        full = self.param_count()
        m = self.moe
        n_moe_layers = sum(1 for s in self.pattern if s.mlp == "moe") * self.n_repeats
        inactive = n_moe_layers * (m.n_experts - m.top_k) * 3 * self.d_model * m.d_ff
        return full - inactive
