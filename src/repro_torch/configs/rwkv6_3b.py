"""rwkv6-3b [ssm]: 32L d2560 (attention-free) d_ff=8960 vocab=65536.
"Finch" — data-dependent per-channel decay [arXiv:2404.05892].

Every layer is an RWKV6 time-mix (WKV linear recurrence, head_dim=64 ->
40 heads) followed by an RWKV channel-mix (squared-ReLU, d_ff=8960).
Constant-size recurrent state (H x 64 x 64 per layer) makes decode O(1)
in context length -> the long_500k cell runs natively.

The paper's balanced-k-means router is inapplicable (no MoE); the arch
still uses SFC data-locality batching (DESIGN.md §Arch-applicability).

Literal copy of the reference's module of the same name (``CONFIG``,
``SMOKE``, ``LONG_CONTEXT_OK``)."""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40,
    d_ff=8960, vocab_size=65536,
    rwkv_head_dim=64, rwkv_lora_rank=64,
    pattern=(LayerSpec("rwkv", "dense"),),
)

SMOKE = ModelConfig(
    name="rwkv6-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=224, vocab_size=128,
    rwkv_head_dim=16, rwkv_lora_rank=8,
    pattern=(LayerSpec("rwkv", "dense"),),
)

LONG_CONTEXT_OK = True  # O(1) state; decode cost independent of context
