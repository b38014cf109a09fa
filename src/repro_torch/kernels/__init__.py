"""Kernels of the port: the assign-backend registry and the wrappers of
the language-model kernels (``ops``), the hand-written CUDA sweep
(``assign_kernel``, ``triton_assign``, source in ``csrc/assign.cu``), the
bootstrap's float64 prefix sum (``scan``, ``csrc/scan.cu``), causal flash
attention (``flash_attention``: ``csrc/flash_attention_tc.cu`` on the
tensor cores for bfloat16, ``csrc/flash_attention.cu`` for float32), the MoE
router (``moe_router_kernel``, ``csrc/router.cu``) and the dense oracles
(``ref``)."""
