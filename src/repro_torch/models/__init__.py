"""The decoder LM of the port (reference: ``repro/models``): ``config``,
``layers`` (RMSNorm, RoPE, attention), ``moe``, ``ssm`` (Mamba and RWKV6)
and ``model``."""
