"""musicgen-large [audio]: 48L d2048 32H (MHA kv=32) d_ff=8192 vocab=2048.
Decoder-only over EnCodec tokens [arXiv:2306.05284]. The EnCodec frontend is
a STUB: inputs are the 4 discrete codebook streams (the transformer backbone
consumes summed codebook embeddings; one LM head per codebook). 32 heads ->
head-TP.

Literal copy of the reference's module of the same name (``CONFIG``,
``SMOKE``, ``LONG_CONTEXT_OK``); sharding overrides and training
hyperparameters belong to later slices and are not carried."""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab_size=2048,
    mlp_kind="gelu", rope_theta=1e4,
    input_mode="codebooks", n_codebooks=4,
    pattern=(LayerSpec("full", "dense"),),
)

SMOKE = ModelConfig(
    name="musicgen-smoke",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=8, head_dim=8,
    d_ff=128, vocab_size=64,
    mlp_kind="gelu",
    input_mode="codebooks", n_codebooks=4,
    pattern=(LayerSpec("full", "dense"),),
)

LONG_CONTEXT_OK = False
