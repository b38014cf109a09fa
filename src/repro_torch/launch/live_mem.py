"""Peak live bytes of a PyTorch call, by following its storages: the
port's counterpart of ``repro/launch/hlo_mem.py``.

The reference estimates a compiled program's peak by replaying buffer
liveness over XLA's scheduled HLO text. The port runs eagerly and has no
HLO; it has the aten ops themselves. ``LiveMemory`` is a
``TorchDispatchMode`` that sees every aten op of the call, the autograd
engine's backward included:

* an op output whose storage is new (not one the mode has seen, not one
  of the call's arguments) goes live at the op with its storage's bytes;
* it dies when the last tensor on that storage dies (a weak reference to
  the storage, which PyTorch keeps alive as long as any tensor, view or
  tensor saved for the backward holds it);
* views, in-place ops and ``out=`` writes return a storage that exists
  already and add nothing: the counterpart of the reference's
  ``_ALIAS_OPS``.

It runs on ``meta`` tensors (a dry run at full size with no memory) and
on CPU tensors (the tests). Storages made before the mode was entered
(the call's arguments: parameters, state, cache, batch) are not counted:
``peak`` is the call's temporaries and outputs, the reference's temp
bytes, and the dry run adds the arguments to it. What an op allocates
inside its own kernel and frees before returning (a CUDA library's
workspace) is not an output and is not seen. The hand-written kernels'
``meta`` routes (``kernels/meta.py``) allocate their outputs and scratch
through aten, so those are seen, and report the tensors they read.
"""
from __future__ import annotations

import threading
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import meta as KMETA


def tensors(tree):
    """The tensors of a tree of lists, tuples and dicts."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from tensors(x)


def storage_key(t: torch.Tensor) -> int:
    """The identity of ``t``'s storage, shared by its views."""
    return t.untyped_storage()._cdata


def storage_bytes(tree) -> int:
    """Bytes of the distinct storages of the tensors in ``tree`` (views
    of one storage counted once)."""
    seen = {}
    for t in tensors(tree):
        seen[storage_key(t)] = t.untyped_storage().nbytes()
    return sum(seen.values())


class LiveMemory(TorchDispatchMode):
    """Live bytes over a call: ``with LiveMemory() as mem: fn()``, then
    ``mem.peak`` (bytes), ``mem.live`` (bytes still live: the outputs,
    and anything kept), ``mem.allocated`` (bytes of every storage made,
    the reference CPU backend's ``temp_size``), ``mem.read`` (the
    ``storage_key`` of every storage an op other than a view read) and
    ``mem.largest_at_peak()``."""

    def __init__(self):
        super().__init__()
        self._lock = threading.Lock()
        self._live: dict = {}      # storage key -> bytes
        self._events: list = []    # (key, +bytes | -bytes, op, shape, dtype)
        self._refs: dict = {}
        self.live = 0
        self.peak = 0
        self.allocated = 0
        self.read: set = set()     # keys of every storage an op read
        self._peak_at = 0

    def __enter__(self):
        self._kernels = KMETA.kernel_costs()
        self._kernel_reads = self._kernels.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        self._kernels.__exit__(*exc)
        for *_, reads in self._kernel_reads:
            self.read.update(reads)
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        inputs = {storage_key(a) for a in tensors((args, kwargs))}
        if not func.is_view:        # a view reads nothing
            with self._lock:
                self.read |= inputs
        for t in tensors(out):
            if t.device.type not in ("meta", "cpu"):
                raise ValueError(f"LiveMemory follows meta and CPU tensors, "
                                 f"{func} returned one on {t.device}")
            st = t.untyped_storage()
            key = st._cdata
            with self._lock:
                if key in self._refs:
                    continue
            if key in inputs:       # a view, in-place op or out= of these
                continue
            with self._lock:
                nbytes = st.nbytes()
                self._live[key] = nbytes
                self._refs[key] = weakref.ref(
                    st, lambda _, key=key: self._free(key))
                self.live += nbytes
                self.allocated += nbytes
                self._events.append((key, nbytes, str(func.overloadpacket),
                                     tuple(t.shape), str(t.dtype)))
                if self.live > self.peak:
                    self.peak = self.live
                    self._peak_at = len(self._events)
        return out

    def _free(self, key) -> None:
        with self._lock:
            self._refs.pop(key, None)
            nbytes = self._live.pop(key, None)
            if nbytes is None:
                return
            self.live -= nbytes
            self._events.append((key, -nbytes, None, None, None))

    def largest_at_peak(self, n: int = 8) -> list:
        """The ``n`` largest storages live at the peak, largest first:
        ``{"bytes", "op", "shape", "dtype"}`` of the op that made each."""
        with self._lock:
            events = self._events[:self._peak_at]
        live = {}
        for key, nbytes, op, shape, dtype in events:
            if nbytes > 0:
                live[key] = {"bytes": nbytes, "op": op, "shape": list(shape),
                             "dtype": dtype}
            else:
                live.pop(key, None)
        return sorted(live.values(), key=lambda r: -r["bytes"])[:n]
