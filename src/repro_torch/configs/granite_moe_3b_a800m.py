"""granite-moe-3b-a800m [moe]: 32L d1536 24H (GQA kv=8) d_ff=512 (per
expert) vocab=49155, MoE 40e top-8 on every layer
[hf:ibm-granite/granite-3.0-*-base family]. Literal copy of the
reference's ``repro/configs/granite_moe_3b_a800m.py``.

Param check: 32 x 40 x 3*1536*512 = 3.0B total; top-8 active ~= 0.8B.
vocab 49155 padded to 49280 (128 lanes). Balanced-k-means router: with 40
experts and top-8 this is the densest routing problem in the pool."""
from repro_torch.models.config import LayerSpec, ModelConfig, MoEConfig

_MOE = MoEConfig(n_experts=40, top_k=8, d_ff=512,
                 capacity_factor=1.25, router="balanced_kmeans")

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8,
    d_ff=512, vocab_size=49155,
    mlp_kind="swiglu", rope_theta=1e4,
    moe=_MOE,
    pattern=(LayerSpec("full", "moe"),),
)

SMOKE = ModelConfig(
    name="granite-smoke",
    n_layers=2, d_model=48, n_heads=6, n_kv_heads=2, head_dim=8,
    d_ff=32, vocab_size=131,          # odd vocab preserved (padding path)
    mlp_kind="swiglu",
    moe=MoEConfig(n_experts=10, top_k=4, d_ff=32, capacity_factor=1.5,
                  router="balanced_kmeans"),
    pattern=(LayerSpec("full", "moe"),),
)

LONG_CONTEXT_OK = False
