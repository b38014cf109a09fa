"""Core algorithms of the port: balanced k-means, the SFC bootstrap, the
single-device partitioner, baselines, metrics and the mesh zoo."""
