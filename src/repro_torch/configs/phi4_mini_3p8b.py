"""phi4-mini-3.8b [dense]: 32L d3072 24H (GQA kv=8) d_ff=8192 vocab=200064.
RoPE + SwiGLU + GQA [arXiv:2412.08905]. 24 heads % 16 != 0 -> seq-SP.

Literal copy of the reference's module of the same name (``CONFIG``,
``SMOKE``, ``LONG_CONTEXT_OK``); sharding overrides and training
hyperparameters belong to later slices and are not carried."""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8,
    d_ff=8192, vocab_size=200064,
    mlp_kind="swiglu", rope_theta=1e4,
    pattern=(LayerSpec("full", "dense"),),
)

SMOKE = ModelConfig(
    name="phi4-smoke",
    n_layers=2, d_model=48, n_heads=6, n_kv_heads=2,
    d_ff=128, vocab_size=160, head_dim=8,
    mlp_kind="swiglu",
    pattern=(LayerSpec("full", "dense"),),
)

LONG_CONTEXT_OK = False
