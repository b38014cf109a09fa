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


def dryrun_argument_bytes(arch, seq, batch, mode):
    """``memory_analysis().argument_size_in_bytes`` of the reference's
    step for ``arch``'s SMOKE config at one ``ShapeCell(seq, batch,
    mode)``, compiled on one CPU device: what ``repro.launch.dryrun``'s
    ``build_cell`` lowers (the train step with the arch's
    ``TRAIN_HPARAMS`` and remat, ``prefill``, or the serve step with a
    cache and an int32 position), without importing that module, whose
    first lines rewrite ``XLA_FLAGS`` for 512 host devices."""
    import jax
    import jax.numpy as jnp
    from repro import configs
    from repro.dist.rules import resolve_rules
    from repro.launch.mesh import make_host_mesh
    from repro.launch.shapes import ShapeCell, input_specs
    from repro.models import model as M
    from repro.serve.engine import make_serve_step
    from repro.train.step import (TrainHParams, abstract_train_state,
                                  make_train_step)
    cfg = configs.get_config(arch, smoke=True)
    cell = ShapeCell(mode, seq, batch, mode)
    rules = resolve_rules(make_host_mesh(1, 1), cfg, mode, batch_size=batch,
                          overrides=configs.sharding_overrides(arch, mode))
    batch_specs = input_specs(cfg, cell)
    if mode == "train":
        hp = TrainHParams(remat=True, **dict(
            getattr(configs.get(arch), "TRAIN_HPARAMS", {})))
        lowered = jax.jit(make_train_step(cfg, rules, hp)).lower(
            abstract_train_state(cfg, hp), batch_specs)
    elif mode == "prefill":
        lowered = jax.jit(lambda p, b: M.prefill(p, b, cfg, rules)).lower(
            M.abstract_params(cfg), batch_specs)
    else:
        cache = jax.eval_shape(lambda: M.init_cache(cfg, batch, seq, rules))
        key = "embeddings" if cfg.input_mode == "embeddings" else "tokens"
        lowered = jax.jit(make_serve_step(cfg, rules)).lower(
            M.abstract_params(cfg), cache, batch_specs[key],
            jax.ShapeDtypeStruct((), jnp.int32))
    compiled = reference(lowered.compile)
    return int(compiled.memory_analysis().argument_size_in_bytes)
