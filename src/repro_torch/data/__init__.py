"""The data pipeline (reference: ``repro/data``)."""
from .pipeline import Prefetcher, SyntheticLM, sfc_batch_order

__all__ = ["SyntheticLM", "Prefetcher", "sfc_batch_order"]
