"""phi3-mini-3.8b [dense]: 32L d3072 32H (MHA kv=32) d_ff=8192 vocab=32064.
RoPE + SwiGLU [arXiv:2404.14219]. 32 heads divide 16 -> head-TP.

Literal copy of the reference's module of the same name (``CONFIG``,
``SMOKE``, ``LONG_CONTEXT_OK``); sharding overrides and training
hyperparameters belong to later slices and are not carried."""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab_size=32064,
    mlp_kind="swiglu", rope_theta=1e4,
    pattern=(LayerSpec("full", "dense"),),
)

SMOKE = ModelConfig(
    name="phi3-smoke",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=8,
    d_ff=160, vocab_size=96, head_dim=8,
    mlp_kind="swiglu",
    pattern=(LayerSpec("full", "dense"),),
)

LONG_CONTEXT_OK = False
