"""``{"kind": "drifting_hotspot", "amplitude": A, "sigma": S, "start":
[x, y], "velocity": [vx, vy], "base": B}``: the frozen ``DriftingHotspot``
of ``reference/meshes.py``, a Gaussian load whose center moves by
``velocity`` a step."""
from portbench.reference.meshes import DriftingHotspot

KEYS = ("amplitude", "sigma", "start", "velocity", "base")


def weights(spec, points, t, gen):
    params = {key: tuple(v) if isinstance(v, list) else v
              for key, v in spec.items() if key != "kind"}
    return DriftingHotspot(**params).weights_at(points, t)
