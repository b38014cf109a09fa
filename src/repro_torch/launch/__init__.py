"""Command-line drivers of the port (reference: ``repro/launch``)."""
