"""The benchmark of ``repro_torch`` on the H100: ``python3 -m
portbench.run``. See PERF.md for its cells, metrics and limits."""
