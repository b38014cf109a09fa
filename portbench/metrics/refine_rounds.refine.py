"""Label-propagation rounds a refined call, from
``stats["refine"]["rounds"]``."""
from portbench.readers import mean_of


def read(record):
    return mean_of(record, "refine_rounds")
