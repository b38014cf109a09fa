"""The multi-device path over ``torch.distributed`` (reference:
``repro/dist``), and the language model's sharding rules (``rules``).

One rank per process (or per thread, for the CPU tests). A rank's
``Communicator`` stands where the reference passes ``axis_name``: it
all-reduces sums, minima and maxima, and, for the distributed
partitioner's sample sort alone, all-gathers and exchanges
(``all_to_all``). ``rules`` holds the mesh shapes, ``launch`` starts the
ranks when the caller is not one.
"""
from .comm import Communicator, current, reduce, using
from .rules import (COARSE_AXIS, PARTITION_AXIS, REFINE_AXIS, Rules,
                    comm_for, mesh_shape, mesh_size, param_shardings,
                    partition_mesh, partition_mesh2d, resolve_rules)

__all__ = [
    "Communicator", "current", "reduce", "using", "comm_for",
    "mesh_shape", "mesh_size", "partition_mesh", "partition_mesh2d",
    "PARTITION_AXIS", "COARSE_AXIS", "REFINE_AXIS",
    "Rules", "resolve_rules", "param_shardings",
]
