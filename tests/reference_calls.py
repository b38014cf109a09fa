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

import numpy as np

with warnings.catch_warnings():
    warnings.simplefilter("ignore", DeprecationWarning)
    from jax.experimental.shard_map import shard_map  # noqa: F401


def reference(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` with DeprecationWarnings silenced."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return fn(*args, **kwargs)


def dryrun_argument_bytes(arch, seq, batch, mode, mesh=None):
    """``memory_analysis().argument_size_in_bytes`` of the reference's
    step for ``arch``'s SMOKE config at one ``ShapeCell(seq, batch,
    mode)``: what ``repro.launch.dryrun``'s ``build_cell`` lowers (the
    train step with the arch's ``TRAIN_HPARAMS`` and remat, ``prefill``,
    or the serve step with a cache and an int32 position), without
    importing that module, whose first lines rewrite ``XLA_FLAGS`` for
    512 host devices. ``mesh``: None, compiled on one CPU device; else a
    ``(data, model)`` or ``(pod, data, model)`` shape of the virtual CPU
    devices, each argument placed as that ``build_cell`` places it, and
    the bytes are a device's, returned with the batch's part of them:
    ``(argument bytes, batch bytes)``.

    Raises:
        ValueError: ``jit`` refuses an argument whose dimension the mesh
            extent does not divide.
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro import configs
    from repro.dist.rules import param_shardings, resolve_rules
    from repro.launch.mesh import make_compat_mesh, make_host_mesh
    from repro.launch.shapes import (ShapeCell, batch_logical_specs,
                                     input_specs)
    from repro.models import model as M
    from repro.serve.engine import make_serve_step
    from repro.train.step import (TrainHParams, abstract_train_state,
                                  make_train_step,
                                  train_state_logical_specs)
    cfg = configs.get_config(arch, smoke=True)
    cell = ShapeCell(mode, seq, batch, mode)
    jmesh = make_host_mesh(1, 1) if mesh is None else make_compat_mesh(
        tuple(mesh), ("data", "model") if len(mesh) == 2 else
        ("pod", "data", "model"))
    rules = resolve_rules(jmesh, cfg, mode, batch_size=batch,
                          overrides=configs.sharding_overrides(arch, mode))
    batch_specs = input_specs(cfg, cell)
    bshard = {k: rules.sharding(v)
              for k, v in batch_logical_specs(cfg, cell).items()}

    def placed(specs_fn):
        return None if mesh is None else param_shardings(rules, specs_fn())

    def jit(fn, shardings, donate=()):
        if mesh is None:
            return jax.jit(fn)
        return jax.jit(fn, in_shardings=shardings, donate_argnums=donate)

    key = "embeddings" if cfg.input_mode == "embeddings" else "tokens"
    if mode == "train":
        hp = TrainHParams(remat=True, **dict(
            getattr(configs.get(arch), "TRAIN_HPARAMS", {})))
        state = abstract_train_state(cfg, hp)
        sshard = placed(lambda: train_state_logical_specs(cfg, hp))
        lowered = jit(make_train_step(cfg, rules, hp), (sshard, bshard),
                      (0,)).lower(state, batch_specs)
        fed = batch_specs
    elif mode == "prefill":
        psh = placed(lambda: M.param_logical_specs(cfg))
        lowered = jit(lambda p, b: M.prefill(p, b, cfg, rules),
                      (psh, bshard)).lower(M.abstract_params(cfg),
                                           batch_specs)
        fed = batch_specs
    else:
        cache = jax.eval_shape(lambda: M.init_cache(cfg, batch, seq, rules))
        psh = placed(lambda: M.param_logical_specs(cfg))
        csh = placed(lambda: M.cache_logical_specs(cfg))
        pos_sh = None if mesh is None else NamedSharding(jmesh, P())
        lowered = jit(make_serve_step(cfg, rules),
                      (psh, csh, bshard[key], pos_sh), (1,)).lower(
            M.abstract_params(cfg), cache, batch_specs[key],
            jax.ShapeDtypeStruct((), jnp.int32))
        fed = {key: batch_specs[key]}
    compiled = reference(lowered.compile)
    nbytes = int(compiled.memory_analysis().argument_size_in_bytes)
    if mesh is None:
        return nbytes
    fed_bytes = sum(
        int(np.prod(bshard[k].shard_shape(v.shape))) * v.dtype.itemsize
        for k, v in fed.items())
    return nbytes, fed_bytes
