"""What the profiler saw in the traced window.

The window runs under ``torch.profiler`` (CPU and CUDA activities) inside
a ``record_function("portbench.window")``, and each timed call of the
program inside a ``record_function("portbench.call")``. Only the calls
count: the harness's own work between them (making the next input) is
left out. From the profiler's raw events (``kineto_results.events()``:
building ``key_averages`` trees takes minutes at these event counts):

- the calls' time: the sum of their spans (``window_s``);
- the device's busy time: the union of every kernel, copy and set on the
  device, clipped to the calls;
- device time by kernel name, of the device operations that start inside
  a call, and the top of it;
- the idle gaps between busy stretches inside the calls, each put down to
  what the host was doing. A gap in which ``StackSampler`` caught the
  main thread goes to the program line it was in most often (the
  innermost frame inside ``repro_torch``, else the innermost frame); any
  other gap goes to the shortest host event (an operator or a CUDA
  runtime call) that covers at least half of it, else the one that
  overlaps it most.
"""
from __future__ import annotations

import sys
import threading
import time
from collections import Counter
from dataclasses import dataclass, field

import numpy as np

WINDOW = "portbench.window"
CALL = "portbench.call"
GAP_MIN_NS = 20_000        # shorter gaps are summed under one name
NAME_CHARS = 160           # names are cut to this length in the breakdown
LONG_NS = 1_000_000        # host events longer than this are searched apart
SAMPLE_S = 0.001           # the stack sampler's period
PROGRAM = "repro_torch"


class StackSampler:
    """Samples the calling thread's Python stack every ``SAMPLE_S`` from a
    daemon thread while it runs (``with StackSampler() as s:``): a
    (perf_counter_ns, label) pair a sample, the label being ``file:line
    function`` of the innermost frame in the program's package, else of
    the innermost frame."""

    def __init__(self):
        self.samples: list = []
        self._target = threading.get_ident()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()

    def _run(self):
        while not self._stop.wait(SAMPLE_S):
            frame = sys._current_frames().get(self._target)
            if frame is not None:
                self.samples.append((time.perf_counter_ns(), _label(frame)))


def _label(frame) -> str:
    inner = frame
    while frame is not None:
        path = frame.f_code.co_filename
        if PROGRAM in path:
            inner = frame
            break
        frame = frame.f_back
    path = inner.f_code.co_filename
    cut = path.rfind(PROGRAM)
    short = path[cut:] if cut >= 0 else path.rsplit("/", 2)[-1]
    return f"{short}:{inner.f_lineno} {inner.f_code.co_name}"


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernels: dict = field(default_factory=dict)   # name -> [seconds, calls]
    idle_gaps: list = field(default_factory=list)  # [name, seconds], top 10

    def device_ops(self, top: int = 10) -> list:
        rows = sorted(self.kernels.items(), key=lambda kv: -kv[1][0])
        return [[name[:NAME_CHARS], sec] for name, (sec, _) in rows[:top]]


def _is_device(e) -> bool:
    return str(e.device_type()).endswith("CUDA")


def _merge(starts: np.ndarray, ends: np.ndarray):
    """Union of intervals as sorted disjoint (starts, ends)."""
    if starts.size == 0:
        return starts, ends
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    reach = np.maximum.accumulate(e)
    new = np.ones(s.size, dtype=bool)
    new[1:] = s[1:] > reach[:-1]
    groups = np.cumsum(new) - 1
    out_s = s[new]
    out_e = np.zeros(out_s.size, dtype=e.dtype)
    np.maximum.at(out_e, groups, e)
    return out_s, out_e


def summarize(events, sampler: StackSampler | None = None,
              start_ns: int = 0) -> TraceSummary:
    """A ``TraceSummary`` of the profiler's raw events and, where given,
    the stack samples taken over the same window, whose span began at
    ``start_ns`` on ``time.perf_counter_ns``."""
    w0 = None
    dev_s, dev_e, dev_n = [], [], []
    call_s, call_e = [], []
    host_s, host_e, host_n = [], [], []
    for e in events:
        start = e.start_ns()
        end = start + e.duration_ns()
        if _is_device(e):
            if e.is_user_annotation() or e.is_hidden_event():
                continue
            dev_s.append(start)
            dev_e.append(end)
            dev_n.append(e.name())
        elif e.name() == WINDOW:
            w0 = start
        elif e.name() == CALL:
            call_s.append(start)
            call_e.append(end)
        else:
            host_s.append(start)
            host_e.append(end)
            host_n.append(e.name())
    if w0 is None or not call_s:
        raise RuntimeError(f"the trace holds no {WINDOW!r} span or no "
                           f"{CALL!r} span")
    cs, ce = _merge(np.array(call_s, np.int64), np.array(call_e, np.int64))
    ev_s, ev_e = np.array(dev_s, np.int64), np.array(dev_e, np.int64)
    # device time by name, of the operations that start inside a call
    at = np.searchsorted(cs, ev_s, side="right") - 1
    inside = (at >= 0) & (ev_s < ce[np.maximum(at, 0)])
    kernels: dict = {}
    for i in np.flatnonzero(inside):
        row = kernels.setdefault(dev_n[i], [0.0, 0])
        row[0] += (ev_e[i] - ev_s[i]) / 1e9
        row[1] += 1
    ds, de = _merge(ev_s, ev_e)
    busy, gs, ge = 0, [], []
    for c0, c1 in zip(cs, ce):
        a = np.searchsorted(de, c0, side="right")
        b = np.searchsorted(ds, c1, side="left")
        s, e = np.clip(ds[a:b], c0, c1), np.clip(de[a:b], c0, c1)
        busy += int(np.sum(e - s))
        # the idle gaps: before the first busy stretch, between, after
        gs.append(np.concatenate([[c0], e]))
        ge.append(np.concatenate([s, [c1]]))
    gs, ge = np.concatenate(gs), np.concatenate(ge)
    keep = ge > gs
    gs, ge = gs[keep], ge[keep]
    samples = None
    if sampler is not None and sampler.samples:
        # the sampler's clock moved onto the trace's at the window's start
        ts = np.array([t for t, _ in sampler.samples], np.int64)
        samples = (w0 + (ts - start_ns),
                   np.array([lab for _, lab in sampler.samples],
                            dtype=object))
    gaps = _attribute(gs, ge, np.array(host_s, np.int64),
                      np.array(host_e, np.int64), host_n, samples)
    top = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return TraceSummary(window_s=float(np.sum(ce - cs)) / 1e9,
                        busy_s=busy / 1e9, kernels=kernels,
                        idle_gaps=[[name[:NAME_CHARS], sec]
                                   for name, sec in top])


def _attribute(gs, ge, hs, he, names, samples=None) -> dict:
    """Seconds of idle time by the host activity of each gap."""
    out: dict = {}
    small = (ge - gs) < GAP_MIN_NS
    if np.any(small):
        out["gaps under 20 us"] = float(np.sum((ge - gs)[small])) / 1e9
    names = np.array(names, dtype=object)
    dur = he - hs
    long_ = dur >= LONG_NS
    ls, le, ld, ln = hs[long_], he[long_], dur[long_], names[long_]
    order = np.argsort(hs[~long_], kind="stable")
    ss, se = hs[~long_][order], he[~long_][order]
    sd, sn = dur[~long_][order], names[~long_][order]
    for g0, g1 in zip(gs[~small], ge[~small]):
        if samples is not None:
            a, b = np.searchsorted(samples[0], [g0, g1])
            if b > a:
                name = Counter(samples[1][a:b]).most_common(1)[0][0]
                out[name] = out.get(name, 0.0) + (g1 - g0) / 1e9
                continue
        lo = np.searchsorted(ss, g0 - LONG_NS)
        hi = np.searchsorted(ss, g1)
        cs = np.concatenate([ss[lo:hi], ls])
        ce = np.concatenate([se[lo:hi], le])
        cd = np.concatenate([sd[lo:hi], ld])
        cn = np.concatenate([sn[lo:hi], ln])
        overlap = np.minimum(ce, g1) - np.maximum(cs, g0)
        hit = overlap > 0
        if not np.any(hit):
            name = "host outside any traced event"
        else:
            half = overlap >= (g1 - g0) / 2
            if np.any(half):
                name = cn[half][np.argmin(cd[half])]
            else:
                name = cn[np.argmax(overlap)]
        out[name] = out.get(name, 0.0) + (g1 - g0) / 1e9
    return out
