"""``{"kind": "unit"}``: every point weighs 1; the partitioner is handed
no weights."""
KEYS = ()


def weights(spec, points, t, gen):
    return None
