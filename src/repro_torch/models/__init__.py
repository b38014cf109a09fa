"""The decoder LM of the port (reference: ``repro/models``): ``config``,
``layers`` (RMSNorm, RoPE, attention), ``moe`` and ``model``. The SSM
layers (``ssm.py``) are not ported yet (ROADMAP.md, slice F)."""
