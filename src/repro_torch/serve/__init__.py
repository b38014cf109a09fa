"""Language-model serving (reference: ``repro/serve``). The partition
server (``PartitionServer``) comes with slice C (ROADMAP.md)."""
from .engine import Request, ServeEngine, make_serve_step

__all__ = ["make_serve_step", "ServeEngine", "Request"]
