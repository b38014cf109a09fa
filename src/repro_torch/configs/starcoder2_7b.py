"""starcoder2-7b [dense]: 32L d4608 36H (GQA kv=4) d_ff=18432 vocab=49152.
GQA + RoPE, non-gated GELU MLP (d_ff = 4d) [arXiv:2402.19173].

36 heads do not divide the model=16 mesh axis -> seq-SP attention
(DESIGN.md §5).

Literal copy of the reference's module of the same name (``CONFIG``,
``SMOKE``, ``LONG_CONTEXT_OK``); sharding overrides and training
hyperparameters belong to later slices and are not carried."""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b",
    n_layers=32, d_model=4608, n_heads=36, n_kv_heads=4,
    d_ff=18432, vocab_size=49152,
    mlp_kind="gelu", rope_theta=1e5,
    pattern=(LayerSpec("full", "dense"),),
)

SMOKE = ModelConfig(
    name="starcoder2-smoke",
    n_layers=2, d_model=72, n_heads=9, n_kv_heads=3,   # odd heads preserved
    d_ff=288, vocab_size=128, head_dim=8,
    mlp_kind="gelu",
    pattern=(LayerSpec("full", "dense"),),
)

LONG_CONTEXT_OK = False  # pure full attention -> long_500k skipped
