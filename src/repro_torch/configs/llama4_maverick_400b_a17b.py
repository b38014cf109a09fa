"""llama4-maverick-400b-a17b [moe]: 48L d5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 128e top-1 + 1 shared expert, interleaved MoE every other
layer, early fusion (text+vision share the token stream; vision frontend is
a STUB) [hf:meta-llama/Llama-4-Scout-17B-16E family].

Param check: 24 MoE layers x 128 experts x 3*5120*8192 = 386B routed params
(+ dense/attn) == the 400B class; top-1 + shared expert ~= 17B active.
40 heads % 16 != 0 -> seq-SP attention; 128 experts / 16 -> EP over model.
Optimizer moments bf16 (400B class). Balanced-k-means router (paper Eq. 1
influence balancing) is the *default* router for this arch.

Literal copy of the reference's module of the same name (``CONFIG``,
``SMOKE``, ``LONG_CONTEXT_OK``, ``TRAIN_HPARAMS``); sharding overrides
belong to a later slice and are not carried."""
from repro_torch.models.config import LayerSpec, ModelConfig, MoEConfig

_PATTERN = (LayerSpec("full", "dense"), LayerSpec("full", "moe"))

_MOE = MoEConfig(n_experts=128, top_k=1, d_ff=8192,
                 capacity_factor=1.25, router="balanced_kmeans",
                 n_shared_experts=1)

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=8192, vocab_size=202048,
    mlp_kind="swiglu", rope_theta=5e5,
    moe=_MOE,
    param_dtype="bfloat16",    # 400B class: bf16 weights, f32 update math
    moment_dtype="bfloat16",
    pattern=_PATTERN,
)

SMOKE = ModelConfig(
    name="llama4-smoke",
    n_layers=4, d_model=64, n_heads=5, n_kv_heads=1, head_dim=16,
    d_ff=128, vocab_size=192,
    mlp_kind="swiglu",
    moe=MoEConfig(n_experts=8, top_k=1, d_ff=128, capacity_factor=1.5,
                  router="balanced_kmeans", n_shared_experts=1),
    pattern=_PATTERN,
)

LONG_CONTEXT_OK = False  # full attention -> long_500k skipped

# 400B-class: microbatched grad accumulation in bf16 (grads of bf16 params
# are natively bf16; f32 accumulators double their HBM)
TRAIN_HPARAMS = {"microbatches": 2, "grad_acc_dtype": "bfloat16"}
