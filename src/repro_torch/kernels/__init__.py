"""Kernels of the port: the assign-backend registry and the wrappers of
the language-model kernels (``ops``), the hand-written CUDA sweep
(``assign_kernel``, ``triton_assign``, source in ``csrc/assign.cu``), the
bootstrap's float64 prefix sum (``scan``, ``csrc/scan.cu``), causal flash
attention (``flash_attention``, ``csrc/flash_attention.cu``), the MoE
router (``moe_router_kernel``, ``csrc/router.cu``) and the dense oracles
(``ref``)."""
