"""Architecture config registry (reference: ``repro/configs``).

It knows the reference's ten architectures and their CLI aliases, and all
ten are ported (``PORTED``, in the order they were); ``get`` raises
``KeyError`` for an unknown name. Each module exposes
``CONFIG`` (the full configuration), ``SMOKE`` (a reduced one of the same
family for CPU tests) and ``LONG_CONTEXT_OK``, and may expose
``SHARDING_OVERRIDES`` ({mode: {logical: mesh_axes}}, read by
``sharding_overrides``); as in the reference, no config defines it.
"""
from __future__ import annotations

import importlib

ARCHS = [
    "starcoder2_7b",
    "phi4_mini_3p8b",
    "phi3_mini_3p8b",
    "gemma3_1b",
    "musicgen_large",
    "jamba_1p5_large_398b",
    "llama4_maverick_400b_a17b",
    "granite_moe_3b_a800m",
    "rwkv6_3b",
    "internvl2_76b",
]

PORTED = (
    "granite_moe_3b_a800m",
    "phi3_mini_3p8b",
    "phi4_mini_3p8b",
    "starcoder2_7b",
    "gemma3_1b",
    "musicgen_large",
    "internvl2_76b",
    "llama4_maverick_400b_a17b",
    "jamba_1p5_large_398b",
    "rwkv6_3b",
)

# canonical CLI ids (--arch <id>)
ALIASES = {
    "starcoder2-7b": "starcoder2_7b",
    "phi4-mini-3.8b": "phi4_mini_3p8b",
    "phi3-mini-3.8b": "phi3_mini_3p8b",
    "gemma3-1b": "gemma3_1b",
    "musicgen-large": "musicgen_large",
    "jamba-1.5-large-398b": "jamba_1p5_large_398b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "rwkv6-3b": "rwkv6_3b",
    "internvl2-76b": "internvl2_76b",
}


def get(name: str):
    name = ALIASES.get(name, name)
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name}; known: {sorted(ALIASES)}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(name: str, smoke: bool = False):
    mod = get(name)
    return mod.SMOKE if smoke else mod.CONFIG


def long_context_ok(name: str) -> bool:
    return getattr(get(name), "LONG_CONTEXT_OK", False)


def sharding_overrides(name: str, mode: str) -> dict:
    """The arch's {logical: mesh_axes} overrides for ``mode``, the
    ``"all"`` entry first."""
    ov = getattr(get(name), "SHARDING_OVERRIDES", {})
    return dict(ov.get("all", {}), **ov.get(mode, {}))
