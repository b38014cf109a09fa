"""Seconds a cold call spends in the bootstrap (the host permutation, the
copy to the device, the Hilbert keys and the center picks), from the
solve's own ``stats["levels"][0]["seconds"]["bootstrap"]``."""
from portbench.readers import mean_of


def read(record):
    return mean_of(record, "bootstrap_s")
