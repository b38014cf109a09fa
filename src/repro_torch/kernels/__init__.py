"""Kernels of the port: the assign-backend registry (``ops``), the
hand-written CUDA sweep (``assign_kernel``, ``triton_assign``, source in
``csrc/assign.cu``), the bootstrap's float64 prefix sum (``scan``, source
in ``csrc/scan.cu``) and the dense oracles (``ref``)."""
