"""jamba-1.5-large-398b [hybrid]: 72L d8192 64H (GQA kv=8) d_ff=24576
vocab=65536, MoE 16e top-2; Mamba:attention 7:1 interleave, MoE every other
layer [arXiv:2403.19887].

Pattern period 8: positions 0-7 are mamba except position 4 (attention);
MoE on odd positions. 64 heads divide 16 -> head-TP; mamba d_inner=16384
is channel-TP over model. Optimizer moments in bf16 (400B class).

Literal copy of the reference's module of the same name (``CONFIG``,
``SMOKE``, ``LONG_CONTEXT_OK``, ``TRAIN_HPARAMS``)."""
from repro_torch.models.config import LayerSpec, ModelConfig, MoEConfig

_PATTERN = tuple(
    LayerSpec("full" if i == 4 else "mamba", "moe" if i % 2 == 1 else "dense")
    for i in range(8)
)

_MOE = MoEConfig(n_experts=16, top_k=2, d_ff=24576,
                 capacity_factor=1.25, router="balanced_kmeans")

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=24576, vocab_size=65536,
    mlp_kind="swiglu", rope_theta=1e4,
    moe=_MOE,
    mamba_d_state=16, mamba_d_conv=4, mamba_expand=2,
    param_dtype="bfloat16",    # 400B class: bf16 weights, f32 update math
    moment_dtype="bfloat16",
    pattern=_PATTERN,
)

SMOKE = ModelConfig(
    name="jamba-smoke",
    n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=128,
    mlp_kind="swiglu",
    moe=MoEConfig(n_experts=4, top_k=2, d_ff=128,
                  capacity_factor=1.5, router="balanced_kmeans"),
    mamba_d_state=8, mamba_d_conv=4, mamba_expand=2,
    pattern=_PATTERN,
)

LONG_CONTEXT_OK = True  # 7/8 of layers are SSM; attention is 1/8

# heaviest train cell in the pool (72L hybrid + MoE): 2 grad-accum
# microbatches halve the live activation/dispatch footprint
TRAIN_HPARAMS = {"microbatches": 2, "grad_acc_dtype": "bfloat16"}
