"""internvl2-76b [vlm]: 80L d8192 64H (GQA kv=8) d_ff=28672 vocab=128256.
InternViT-6B + LLaMA-class 70B language backbone [arXiv:2404.16821].

Per the assignment, only the transformer BACKBONE is specified; the
InternViT/pixel-shuffle frontend is a STUB — ``input_specs()`` feeds
precomputed patch+text embeddings ([B, S, d_model] bf16), so
``input_mode="embeddings"`` (no input embedding table; LM head to the
128256 text vocab remains). Param check: 80 x (4*8192^2*(72/64) attn +
3*8192*28672 mlp) ~= 70B + 1.05B lm_head (ViT 6B stubbed).
64 heads / 16 -> head-TP.

Literal copy of the reference's module of the same name (``CONFIG``,
``SMOKE``, ``LONG_CONTEXT_OK``, ``TRAIN_HPARAMS``); sharding overrides
belong to a later slice and are not carried."""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=28672, vocab_size=128256,
    mlp_kind="swiglu", rope_theta=1e6,
    input_mode="embeddings",
    pattern=(LayerSpec("full", "dense"),),
)

SMOKE = ModelConfig(
    name="internvl2-smoke",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
    d_ff=160, vocab_size=128,
    mlp_kind="swiglu",
    input_mode="embeddings",
    pattern=(LayerSpec("full", "dense"),),
)

LONG_CONTEXT_OK = False  # pure full attention -> long_500k skipped

# d_model=8192 embeddings-input activations are the largest in the pool;
# 2 grad-accum microbatches halve the live footprint (same step FLOPs)
TRAIN_HPARAMS = {"microbatches": 2}
