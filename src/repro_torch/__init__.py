"""PyTorch/CUDA port of the balanced k-means partitioner (Geographer).

The JAX package ``repro`` is the reference; this package imports nothing
of it. Entry points run on the card unless the caller passes
``device="cpu"``. The front door is ``repro_torch.partition.partition``.
"""
