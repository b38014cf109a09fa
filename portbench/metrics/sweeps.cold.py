"""Assign-kernel sweeps a cold call, from ``kernels.ops.launch_counts()``
read around each call."""
from portbench.readers import kernel_sweeps


def read(record):
    return kernel_sweeps(record)
