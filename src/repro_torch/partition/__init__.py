"""The partitioning front door of the port: one problem type, one
``partition()`` call and a pluggable algorithm registry (flat path)."""
from . import algorithms  # noqa: F401  (populates the registry on import)
from .engine import partition
from .problem import NotYetPortedError, PartitionProblem, PartitionResult
from .registry import (UnknownMethodError, available_methods,
                       distributed_methods, get_algorithm,
                       register_algorithm, resolve_method,
                       supports_devices, supports_warm_start,
                       warm_start_methods)

__all__ = [
    "PartitionProblem", "PartitionResult", "partition", "NotYetPortedError",
    "register_algorithm", "get_algorithm", "available_methods",
    "resolve_method", "UnknownMethodError",
    "supports_devices", "distributed_methods",
    "supports_warm_start", "warm_start_methods",
]
