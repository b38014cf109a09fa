"""The multi-device path over ``torch.distributed`` (counterpart of the
partition half of ``repro/dist``).

One rank per process (or per thread, for the CPU tests). A rank's
``Communicator`` stands where the reference passes ``axis_name``: it
all-reduces sums, minima and maxima, and, for the distributed
partitioner's sample sort alone, all-gathers and exchanges
(``all_to_all``). ``rules`` holds the mesh shapes, ``launch`` starts the
ranks when the caller is not one.
"""
from .comm import Communicator, current, reduce, using
from .rules import (COARSE_AXIS, PARTITION_AXIS, REFINE_AXIS, comm_for,
                    mesh_shape, mesh_size, partition_mesh, partition_mesh2d)

__all__ = [
    "Communicator", "current", "reduce", "using", "comm_for",
    "mesh_shape", "mesh_size", "partition_mesh", "partition_mesh2d",
    "PARTITION_AXIS", "COARSE_AXIS", "REFINE_AXIS",
]
