"""String-keyed algorithm registry (counterpart of
``repro/partition/registry.py``).

An algorithm is any callable ``fn(problem: PartitionProblem, **opts) ->
PartitionResult``. Register with::

    @register_algorithm("mymethod", aliases=("mm",))
    def _my_method(problem, **opts):
        ...

``get_algorithm`` resolves aliases and raises ``UnknownMethodError`` (a
``KeyError``) with the available names for anything unregistered, so typos
fail loudly at the front door.

Two capability flags ride on each registration:

* ``supports_devices`` — the algorithm has a multi-device ``devices=P``
  path (``geographer``, over ``torch.distributed``); ``partition()``
  rejects ``devices=`` for anything else before the algorithm runs.
* ``supports_warm_start`` — the algorithm can resume from a previous
  ``PartitionResult``'s (centers, influence) state; ``repartition()``
  reads this flag.
"""
from __future__ import annotations

from typing import Callable

_REGISTRY: dict[str, Callable] = {}
_ALIASES: dict[str, str] = {}
_SUPPORTS_DEVICES: set[str] = set()
_SUPPORTS_WARM_START: set[str] = set()


class UnknownMethodError(KeyError):
    pass


def register_algorithm(name: str, aliases: tuple[str, ...] = (),
                       supports_devices: bool = False,
                       supports_warm_start: bool = False):
    """Decorator: register ``fn`` under ``name`` (+ aliases).

    Args:
        name: canonical registry key.
        aliases: extra names resolving to ``name``.
        supports_devices: declares a multi-device ``devices=`` path.
        supports_warm_start: declares that ``repartition()`` may warm-start
            this algorithm from a previous result's (centers, influence).

    Returns:
        The decorator; the wrapped function is returned unchanged.
    """
    def deco(fn: Callable) -> Callable:
        if name in _REGISTRY:
            raise ValueError(f"algorithm {name!r} already registered")
        _REGISTRY[name] = fn
        if supports_devices:
            _SUPPORTS_DEVICES.add(name)
        if supports_warm_start:
            _SUPPORTS_WARM_START.add(name)
        for a in aliases:
            _ALIASES[a] = name
        return fn
    return deco


def resolve_method(name: str) -> str:
    """Canonical name for ``name`` (resolving aliases)."""
    name = _ALIASES.get(name, name)
    if name not in _REGISTRY:
        raise UnknownMethodError(
            f"unknown partition method {name!r}; available: "
            f"{available_methods()} (aliases: {sorted(_ALIASES)})")
    return name


def get_algorithm(name: str) -> Callable:
    """The registered callable for ``name`` (aliases resolved)."""
    return _REGISTRY[resolve_method(name)]


def supports_devices(name: str) -> bool:
    """True when ``name`` (or its alias) has a multi-device path."""
    return resolve_method(name) in _SUPPORTS_DEVICES


def supports_warm_start(name: str) -> bool:
    """True when ``name`` (or its alias) can be warm-started by
    ``repartition()`` from a previous result's (centers, influence)."""
    return resolve_method(name) in _SUPPORTS_WARM_START


def distributed_methods() -> list[str]:
    """Sorted names of all methods with a multi-device path."""
    return sorted(_SUPPORTS_DEVICES)


def warm_start_methods() -> list[str]:
    """Sorted names of all methods supporting warm-started repartition."""
    return sorted(_SUPPORTS_WARM_START)


def available_methods() -> list[str]:
    """Sorted canonical names of every registered algorithm."""
    return sorted(_REGISTRY)
