"""Launch P local ranks and run one function on each (SPMD).

``partition(problem, devices=P)`` and the other entry points with a
``devices=`` argument run on the calling rank when the caller is one (a
launcher made it so, or the caller initialized the default process group,
as under ``torchrun``). Otherwise they call ``run`` here, which launches
P ranks on this host, calls the entry point again on every rank and
returns rank 0's result: the reference's single-controller call.

Ranks are processes started with the ``spawn`` method (CUDA does not
survive ``fork``). The parent makes the store (a ``TCPStore`` on the
loopback); every rank joins the default process group through it, binds
to card ``rank % torch.cuda.device_count()`` when it runs on the card,
and reports its return value or its exception through a queue. The first
exception of any rank is raised in the caller, and the other ranks are
killed rather than left blocked in a collective. Every collective of the
group has the launch's timeout, and so does the launch as a whole.

``threads=True`` runs the ranks as threads of the calling process, each
with its own ``ProcessGroupGloo`` over one in-memory store: CPU tensors
only, for callers (the tests) that cannot pay a process start per rank.

The backend follows one rule (``choose_backend``): NCCL when every rank
has a card of its own, gloo otherwise, including P ranks that share one
card. Asking for NCCL with fewer cards than ranks raises; nothing
switches backend after a failure.
"""
from __future__ import annotations

import datetime
import os
import pickle
import queue as queue_mod
import threading
import time
import traceback

import torch
import torch.distributed as tdist

from .comm import Communicator, current, using
from .rules import mesh_size

#: seconds a launch, and every collective in it, may take
DEFAULT_TIMEOUT = 1800.0
_HOST = "127.0.0.1"


class RankError(RuntimeError):
    """A rank of a launch failed; the message holds its traceback."""


def choose_backend(device, nranks: int, backend: str | None = None) -> str:
    """The backend for ``nranks`` ranks on ``device``: ``"nccl"`` when the
    device is CUDA and every rank has a card of its own, else ``"gloo"``
    (CPU tensors, or ranks sharing cards).

    Raises:
        ValueError: ``backend="nccl"`` for CPU ranks or for more ranks
            than cards, or an unknown backend.
    """
    dev = torch.device("cuda" if device is None else device)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    if backend is None:
        return "nccl" if dev.type == "cuda" and nranks <= cards else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got "
                         f"{backend!r}")
    if backend == "nccl" and nranks > cards:
        raise ValueError(
            f"NCCL needs a card per rank: {nranks} ranks on {dev.type} "
            f"with {cards} card(s); use backend='gloo' (ranks sharing a "
            "card) or fewer ranks")
    return backend


def rank_device(device, rank: int) -> torch.device:
    """The device of rank ``rank``: a CUDA device without an index binds
    to card ``rank % device_count``; any other device is kept."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", rank % max(torch.cuda.device_count(),
                                               1))
    return dev


def needed(devices) -> bool:
    """True when an entry point called with ``devices`` must launch its
    ranks (the caller is no rank)."""
    return devices is not None and current() is None


def run(fn, devices, device, /, *args, **kwargs):
    """``fn(*args, **kwargs)`` on every rank of the mesh ``devices`` (the
    entry point itself, called again inside the ranks); rank 0's return
    value. A result whose ``problem`` is ``args[0]`` gets the caller's
    object back (it is not sent home)."""
    return launch(fn, mesh_size(devices), args=args,
                  kwargs=kwargs, device=device)


def _strip(value, args):
    """(value to send home, whether its ``problem`` was args[0])."""
    if args and getattr(value, "problem", None) is args[0]:
        value.problem = None
        return value, True
    return value, False


def _restore(value, stripped, args):
    if stripped:
        value.problem = args[0]
    return value


def _loopback_env() -> None:
    # every rank of a launch is on this host: the group's sockets bind to
    # the loopback unless the caller chose an interface
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")


def _rank_main(rank, nranks, port, backend, device, timeout, fn, args,
               kwargs, results):
    """Body of one spawned rank: join the group, run ``fn``, report. A
    failure is reported before anything else, so the caller can stop the
    other ranks at once; the group is left to the end of the process."""
    try:
        _loopback_env()
        dev = rank_device(device, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        td = datetime.timedelta(seconds=timeout)
        store = tdist.TCPStore(_HOST, port, is_master=False, timeout=td)
        # NCCL binds the group to the rank's card and makes its
        # communicator here, not inside the first all-reduce
        tdist.init_process_group(
            backend, store=store, rank=rank, world_size=nranks, timeout=td,
            device_id=dev if backend == "nccl" else None)
        comm = Communicator(
            tdist.group.WORLD, rank, nranks, backend=backend,
            subgroup_factory=lambda ranks: tdist.new_group(ranks))
        with using(comm):
            value = fn(*args, **kwargs)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        value, stripped = _strip(value, args) if rank == 0 else (None,
                                                                 False)
        payload = pickle.dumps((value, stripped))
    except BaseException as e:                # report, then end the rank
        text = "".join(traceback.format_exception(e))
        try:
            exc = pickle.dumps(e)
        except Exception:                     # noqa: BLE001 - unpicklable
            exc = None
        results.put(("err", rank, (exc, text)))
        if not isinstance(e, Exception):
            raise
        return
    results.put(("ok", rank, payload))
    tdist.destroy_process_group()


def _raise_rank_error(rank, exc, text):
    err = RankError(f"rank {rank} failed:\n{text}")
    if exc is not None:
        original = pickle.loads(exc)
        if isinstance(original, Exception):
            raise original from err
    raise err


def _stop(procs, grace: float = 5.0) -> None:
    for p in procs:
        if p.is_alive():
            p.terminate()
    end = time.monotonic() + grace
    for p in procs:
        p.join(max(end - time.monotonic(), 0.1))
        if p.is_alive():
            p.kill()
            p.join(grace)


def launch(fn, nranks: int, *, args=(), kwargs=None, device="cuda",
           backend: str | None = None, timeout: float | None = None,
           threads: bool = False):
    """Run ``fn(*args, **kwargs)`` on ``nranks`` local ranks, each with
    its communicator active (``comm.current()``); return rank 0's value.

    Args:
        fn: a module-level function (it is sent to the ranks by name).
        nranks: number of ranks P.
        args, kwargs: what every rank passes to ``fn``.
        device: the ranks' device; a CUDA device binds rank r to card
            ``r % device_count``.
        backend: None for the rule of ``choose_backend``, or "nccl" /
            "gloo".
        timeout: seconds for the whole launch and for every collective
            (None: ``DEFAULT_TIMEOUT``).
        threads: ranks as threads of this process (gloo, CPU only).

    Raises:
        The first failing rank's exception (chained to a ``RankError``
        with its traceback), ``RankError`` for a rank that died without
        one, ``TimeoutError`` when the launch outlives its timeout.
    """
    kwargs = dict(kwargs or {})
    nranks = int(nranks)
    if nranks < 1:
        raise ValueError(f"nranks must be >= 1, got {nranks}")
    timeout = DEFAULT_TIMEOUT if timeout is None else float(timeout)
    backend = choose_backend(device, nranks, backend)
    if threads:
        if torch.device(device).type != "cpu" or backend != "gloo":
            raise ValueError("threads=True runs gloo ranks on the CPU; got "
                             f"device={device!r}, backend={backend!r}")
        return _launch_threads(fn, nranks, args, kwargs, timeout)
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    td = datetime.timedelta(seconds=timeout)
    store = tdist.TCPStore(_HOST, 0, is_master=True, timeout=td,
                           wait_for_workers=False)
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True, args=(
        r, nranks, store.port, backend, device, timeout, fn, args, kwargs,
        results)) for r in range(nranks)]
    deadline = time.monotonic() + timeout
    value, done = None, set()
    try:
        for p in procs:
            p.start()
        while len(done) < nranks:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"launch of {nranks} ranks exceeded {timeout:.0f} s "
                    f"(ranks {sorted(set(range(nranks)) - done)} not done)")
            try:
                msg = results.get(timeout=min(left, 0.5))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in done and p.exitcode not in (None, 0)]
                if not dead:
                    continue
                try:        # its report may still be on the way
                    msg = results.get(timeout=2.0)
                except queue_mod.Empty:
                    raise RankError(
                        f"rank {dead[0]} ended with exit code "
                        f"{procs[dead[0]].exitcode} and no result") from None
            status, rank, payload = msg
            if status == "err":
                _raise_rank_error(rank, *payload)
            done.add(rank)
            if rank == 0:
                value = _restore(*pickle.loads(payload), args)
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
        return value
    finally:
        _stop(procs)
        results.close()
        del store


def _launch_threads(fn, nranks, args, kwargs, timeout):
    """``launch`` with the ranks as threads over one ``HashStore``. When a
    rank fails, the others leave their pending all-reduce at once
    (``CancelledError``), but gloo keeps that operation until its timeout:
    the group's destructor then waits for it, up to ``timeout`` seconds."""
    store = tdist.HashStore()
    td = datetime.timedelta(seconds=timeout)
    out: list = [None] * nranks
    errors: list = []
    cancel = threading.Event()

    def gloo(st, rank, size):
        opts = tdist.ProcessGroupGloo._Options()
        opts._timeout = td
        opts._devices = [tdist.ProcessGroupGloo.create_device(
            interface="lo")]
        return tdist.ProcessGroupGloo(st, rank, size, opts)

    def body(rank):
        try:
            group = gloo(store, rank, nranks)
            made = iter(range(1 << 30))

            def subgroup(ranks):
                # every rank makes every subgroup in the same order, so
                # the n-th subgroup has the same store prefix on each
                tag = next(made)
                if rank not in ranks:
                    return None
                return gloo(tdist.PrefixStore(f"sub{tag}", store),
                            ranks.index(rank), len(ranks))

            comm = Communicator(group, rank, nranks, backend="gloo",
                                subgroup_factory=subgroup, cancel=cancel)
            with using(comm):
                out[rank] = fn(*args, **kwargs)
        except BaseException as e:             # noqa: BLE001 - reported
            errors.append((rank, e))
            cancel.set()        # frees the ranks waiting on this one

    workers = [threading.Thread(target=body, args=(r,), daemon=True,
                                name=f"rank{r}") for r in range(nranks)]
    deadline = time.monotonic() + timeout
    for w in workers:
        w.start()
    for w in workers:
        w.join(max(deadline - time.monotonic(), 0.0))
    if any(w.is_alive() for w in workers):
        raise TimeoutError(f"{nranks} thread ranks exceeded {timeout:.0f} s")
    if errors:
        # the first error is the failing rank's own; the ranks it freed
        # append theirs (CancelledError) after it
        rank, e = errors[0]
        raise e from RankError(f"rank {rank} failed")
    return out[0]
