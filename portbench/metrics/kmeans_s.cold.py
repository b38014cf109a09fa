"""Seconds a cold call spends in balanced k-means, from the solve's own
``stats["levels"][0]["seconds"]["kmeans"]``."""
from portbench.readers import mean_of


def read(record):
    return mean_of(record, "kmeans_s")
