"""Point-set generators, one module a kind, found by a configuration's
``"points": {"kind": ...}``. A module has ``KEYS`` (the parameters it
reads), ``size(spec) -> (n, d)``, ``points(spec, gen, device)`` ([n, d]
float64 on the device, drawn from ``gen``), ``graph(spec, device)``
((indptr, indices) int64 tensors, or None) and ``cut(spec, size)`` (the
spec at a toy size, for the CPU tests)."""
