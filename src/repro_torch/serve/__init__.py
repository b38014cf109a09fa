"""Language-model serving and partition serving (reference:
``repro/serve``)."""
from .engine import Request, ServeEngine, make_serve_step
from .partition_server import (DEFAULT_TIERS, PartitionRequest,
                               PartitionResponse, PartitionServer,
                               request_stream)

__all__ = [
    "make_serve_step", "ServeEngine", "Request",
    "PartitionServer", "PartitionRequest", "PartitionResponse",
    "DEFAULT_TIERS", "request_stream",
]
