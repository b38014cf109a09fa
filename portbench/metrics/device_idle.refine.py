"""% of the traced window in which the device ran no kernel, copy or set:
one minus the union of the device's intervals in the profiler's trace
over the window."""
from portbench.readers import device_idle


def read(record):
    return device_idle(record)
