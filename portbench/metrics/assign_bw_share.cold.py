"""The assign kernel's share of the card's peak bandwidth in the cold
cell, in %: the frozen byte count of a sweep (``reference/roofline.py``)
times the kernel launches the trace holds, at the card's peak bandwidth,
over the kernel's device time in the trace. The byte term of a roofline
alone: no operation bound (the pairs a pruned sweep computes are the
implementation's choice)."""
from portbench.readers import kernel_time
from portbench.reference.roofline import bw_share

# the templates of csrc/assign.cu, as the profiler names their instances
KERNELS = ("assign_pruned<", "assign_any_d<")


def read(record):
    seconds, launches = kernel_time(record, KERNELS)
    return bw_share(record.n, record.d, record.k, launches, seconds,
                    record.device_kind)
