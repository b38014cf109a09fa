"""Seconds a ``partition(refine=True)`` call spends after its solve: the
call's wall time less the solve's own bootstrap and k-means seconds. That
is the refinement: the rounds on the card, the host canonicalization and
the two host ``edge_cut`` passes."""


def read(record):
    vals = [c["wall"] - c["bootstrap_s"] - c["kmeans_s"]
            for c in record.calls if "bootstrap_s" in c]
    return sum(vals) / len(vals) if vals else None
