"""Assign-kernel sweeps a warm repartition step, from
``kernels.ops.launch_counts()`` read around each step."""
from portbench.readers import kernel_sweeps


def read(record):
    return kernel_sweeps(record)
