"""Calls into the reference package from the port's parity tests.

The reference imports ``shard_map`` from ``jax.experimental``. jax 0.9
deprecates that import with a ``DeprecationWarning``, which ``pytest.ini``
turns into an error for the reference's modules (ROADMAP.md, queue 3 item
3). jax warns once per process, at the first such import. This module makes
that first import itself, with the warning silenced, when it is imported.
Every pytest-xdist worker imports every test module while it collects, so
whether a later test meets the warning no longer depends on which test
files the worker happened to run before it.
"""
import warnings

with warnings.catch_warnings():
    warnings.simplefilter("ignore", DeprecationWarning)
    from jax.experimental.shard_map import shard_map  # noqa: F401


def reference(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` with DeprecationWarnings silenced."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return fn(*args, **kwargs)
