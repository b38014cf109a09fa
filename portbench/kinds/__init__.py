"""Traffic kinds, one module a kind, found by a traffic mix's ``"kind"``.
A mix (``traffic/<mix>.json``) is data; its kind is the code that drives
it. A module has

- ``KEYS``: the mix's parameters it reads, besides the ones every mix has
  (``kind``, ``why``, ``metric``, ``warmup``, ``check``, ``limits``);
- ``setup(cell)``: the inputs of ``cell.seed`` and, once a process
  (``cell.warm``), the program warmed up on the mix's shapes;
- ``unit(cell, index) -> (records, answer)``: one unit of the window (a
  timed call, or an episode of them), a record a timed call and what the
  check needs of the unit;
- ``check(cell, answer) -> [numbers]``: each compared number of the
  answer, a dict a checked call or step;
- ``faults(traffic) -> [names]``: the faults of ``faults.FAULTS`` (or of
  the kind's own) that its cells can have.
"""
