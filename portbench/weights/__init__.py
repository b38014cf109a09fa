"""Weight generators, one module a kind, found by a configuration's
``"weights": {"kind": ...}`` or a traffic mix's ``"field"``. A module has
``KEYS`` (the parameters it reads) and ``weights(spec, points, t, gen)``:
[n] float32 on the points' device at step ``t``, drawn from ``gen`` where
it draws, or None for unit weights (the partitioner is handed none)."""
