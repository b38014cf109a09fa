"""Movement iterations a warm repartition step, summed over its balance
retries, from ``stats["iters"]``."""
from portbench.readers import mean_of


def read(record):
    return mean_of(record, "iters")
