"""The partitioning front door of the port: one problem type, one
``partition()`` call, a pluggable algorithm registry, hierarchical
(k1 x k2) recursion, batched solves, dynamic repartitioning via
``repartition(problem, previous)``, and label-propagation refinement via
``refine(problem, result)``."""
from . import algorithms  # noqa: F401  (populates the registry on import)
from .batched import (batched_balanced_kmeans, bucket_balanced_kmeans,
                      build_refinement_batch, sequential_balanced_kmeans)
from .engine import partition
from .hierarchical import factor_k, hierarchical_partition
from .problem import NotYetPortedError, PartitionProblem, PartitionResult
from .refine import (UnknownRefinerError, available_refiners, refine,
                     refinement_budgets, refinement_quantization,
                     refiner_short_name, register_refiner, resolve_refiner)
from .registry import (UnknownMethodError, available_methods,
                       distributed_methods, get_algorithm,
                       register_algorithm, resolve_method,
                       supports_devices, supports_warm_start,
                       warm_start_methods)
from .repartition import (WarmState, greedy_center_match, repartition,
                          weighted_centroids)

__all__ = [
    "PartitionProblem", "PartitionResult", "partition", "repartition",
    "refine", "NotYetPortedError", "WarmState",
    "available_refiners", "resolve_refiner", "register_refiner",
    "refiner_short_name",
    "UnknownRefinerError", "refinement_budgets", "refinement_quantization",
    "hierarchical_partition", "factor_k",
    "batched_balanced_kmeans", "sequential_balanced_kmeans",
    "bucket_balanced_kmeans", "build_refinement_batch",
    "greedy_center_match", "weighted_centroids",
    "register_algorithm", "get_algorithm", "available_methods",
    "resolve_method", "UnknownMethodError",
    "supports_devices", "distributed_methods",
    "supports_warm_start", "warm_start_methods",
]
