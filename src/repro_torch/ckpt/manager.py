"""Manifest-driven, atomic checkpointing with elastic restore (reference:
``repro/ckpt/manager.py``), on the reference's on-disk format:

* a checkpoint is a directory ``step_<n:09d>/`` holding one
  ``leaf_<i:05d>.npy`` a leaf of the state and ``manifest.json`` (step,
  ``n_leaves``, each leaf's file, shape, dtype name and CRC32 of its
  bytes). It is written as ``tmp.step_<n:09d>/``, the manifest last and
  fsynced, and renamed when complete: a crash mid-write never leaves a
  directory that looks complete;
* leaves are numbered in ``optim.adamw.tree_leaves`` order (dict keys
  sorted at every level, as ``jax.tree.flatten`` walks a dict), so the
  reference restores a checkpoint the port wrote and the other way round;
* a bfloat16 leaf is written as its raw 2-byte words under the header
  numpy writes for ``ml_dtypes.bfloat16`` (``'<V2'``) and manifest dtype
  ``"bfloat16"``: the reference's bytes and CRC. On restore the bytes are
  viewed by the manifest's dtype, so the port reads bfloat16 checkpoints
  of either package (the reference's own ``restore`` cannot: ROADMAP.md
  queue 3 item 20);
* ``keep_n`` garbage collection; ``async_save`` writes the files on a
  worker thread.

``save`` returns once the host holds what it will write: the step after
it may update the same tensors in place. A synchronous save streams the
state a leaf at a time through one page-locked buffer the size of the
largest leaf on the card (the host holds one leaf); an asynchronous one
copies every leaf to the host first. ``restore`` reads the next leaf's
file on a thread while it checks and places the current one (the host
holds two leaves). It fills a ``state_like`` leaf that is a tensor in
place, and makes a new tensor for a leaf on the ``meta`` device
(``train.step.abstract_train_state``) on the leaf's sharding's device,
on ``device``, or on the card: a state restores without a second copy of
itself on the device.

Over the ranks of a ``(data, model)`` mesh, every rank calls ``save``
at the same point with ``shardings`` (a tree like the state's,
``train.step.state_shardings``) and ``like`` (the whole shapes,
``train.step.abstract_train_state``): each split leaf is joined whole
over the mesh axes it is split over (its sharding's ``whole``: Mamba's
``in_proj`` by halves, put back in their place), and rank 0 of the
caller's group writes the one-rank format of the whole state, so a
checkpoint does not depend on the mesh that wrote it. ``restore`` with
``shardings`` reads every leaf on every rank and keeps the rank's cut of
it (the sharding's ``local``, the cut that made the shards).

``stats`` holds the last save's and restore's seconds and bytes: on a
save the device-to-host copies (``snapshot_s``) and the file writes with
their CRC32 sums, which run beside them (``write_s``, which holds a
synchronous save's ``snapshot_s`` too: it streams); on a restore the
file reads (``read_s``), the CRC32 sums (``crc_s``) and the copies to
the device (``load_s``); and the whole call (``call_s``).
"""
from __future__ import annotations

import json
import math
import os
import shutil
import threading
import time
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.dist.comm import current
from repro_torch.optim.adamw import tree_leaves, tree_unflatten

# the header numpy writes for an ml_dtypes.bfloat16 array
_BF16_DESCR = "<V2"


def _leaf_name(i: int) -> str:
    return f"leaf_{i:05d}.npy"


def treedef_str(tree) -> str:
    """The tree's structure as ``str(jax.tree.flatten(tree)[1])`` prints a
    tree of dicts: ``PyTreeDef({'a': *, 'b': {'c': *}})``."""
    def walk(t):
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {walk(t[k])}"
                                   for k in sorted(t)) + "}"
        return "*"
    return f"PyTreeDef({walk(tree)})"


def _to_host(x: torch.Tensor, staging: torch.Tensor | None = None
             ) -> np.ndarray:
    """A C-ordered copy of ``x`` on the host as numpy (bfloat16 as its
    int16 words), complete when this returns; in ``staging`` (a uint8
    host buffer of at least ``x``'s bytes) when given, which the array
    then shares."""
    t = x.detach()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    if staging is None:
        host = torch.empty(t.shape, dtype=t.dtype)
    else:
        host = staging[:t.numel() * t.element_size()].view(t.dtype) \
            .view(t.shape)
    host.copy_(t)
    return host.numpy()


def _staging(leaves, scale=None) -> torch.Tensor | None:
    """A page-locked buffer for the largest leaf on a CUDA device (device
    copies into page-locked memory run at the link's rate), or None.
    ``scale``: each leaf's whole size over its own (its shard count)."""
    scale = scale or [1] * len(leaves)
    n = max((x.numel() * x.element_size() * f for x, f in zip(leaves, scale)
             if x.device.type == "cuda"), default=0)
    return torch.empty(n, dtype=torch.uint8, pin_memory=True) if n else None


def _read(path: str):
    t = time.perf_counter()
    arr = np.load(path)
    return arr, time.perf_counter() - t


def _crc(arr: np.ndarray) -> int:
    """CRC32 of the array's bytes in C order (zlib releases the GIL)."""
    return zlib.crc32(arr.reshape(-1).view(np.uint8))


def _dtype_name(x: torch.Tensor) -> str:
    return str(x.dtype).rsplit(".", 1)[-1]


def _write_npy(path: str, arr: np.ndarray, dtype: str) -> None:
    if dtype != "bfloat16":
        np.save(path, arr)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": _BF16_DESCR, "fortran_order": False,
                "shape": arr.shape})
        arr.tofile(f)


def _from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """The file's array as a tensor of the manifest's dtype (sharing its
    memory)."""
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class CheckpointManager:
    def __init__(self, directory: str, keep_n: int = 3,
                 async_save: bool = False):
        self.dir = directory
        self.keep_n = keep_n
        self.async_save = async_save
        self._worker: threading.Thread | None = None
        self.stats: dict = {}
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------- save
    def save(self, step: int, state, shardings=None, like=None) -> None:
        """Write ``state`` (a tree of dicts of tensors) as step ``step``.
        ``shardings``: the state is a rank's shards, cut as that tree says
        (``train.step.state_shardings``), of the whole shapes of ``like``
        (a tree like the state's, of ``meta`` tensors or tensors); every
        rank calls this, and rank 0 of the caller's group
        (``dist.current()``) writes the whole state."""
        leaves = tree_leaves(state)
        treedef = treedef_str(state)
        cuts = ([None] * len(leaves) if shardings is None else
                [(sh, tuple(w.shape)) for sh, w in
                 zip(tree_leaves(shardings), tree_leaves(like))])
        # each leaf's whole size over its shard's
        scale = [1 if c is None else math.prod(c[1]) // max(1, x.numel())
                 for x, c in zip(leaves, cuts)]
        self.wait()                      # one in-flight save at a time
        self.stats["save"] = stats = {"step": step, "snapshot_s": 0.0,
                                      "bytes": 0}
        t0 = time.perf_counter()
        comm = current()

        def whole(x, cut):
            return x if cut is None else cut[0].whole(x, cut[1])

        if shardings is not None and comm is not None and comm.rank != 0:
            for x, c in zip(leaves, cuts):         # the gathers alone
                whole(x, c)
            stats["call_s"] = time.perf_counter() - t0
            return
        if self.async_save:
            host = [(_to_host(whole(x, c)), _dtype_name(x))
                    for x, c in zip(leaves, cuts)]
            stats["snapshot_s"] = time.perf_counter() - t0
            self._worker = threading.Thread(
                target=self._write, args=(step, iter(host), treedef, stats),
                daemon=True)
            self._worker.start()
        else:
            def stream():
                # each array is written before the next copy reuses the
                # buffer: _write consumes one leaf at a time
                staging = _staging(leaves, scale)
                for x, c in zip(leaves, cuts):
                    t = time.perf_counter()
                    x = whole(x, c)
                    arr = _to_host(x, staging if x.device.type == "cuda"
                                   else None)
                    stats["snapshot_s"] += time.perf_counter() - t
                    yield arr, _dtype_name(x)
            self._write(step, stream(), treedef, stats)
        stats["call_s"] = time.perf_counter() - t0

    def wait(self) -> None:
        if self._worker is not None:
            self._worker.join()
            self._worker = None

    def _write(self, step: int, host_leaves, treedef: str, stats) -> None:
        t_all = time.perf_counter()
        final = os.path.join(self.dir, f"step_{step:09d}")
        tmp = os.path.join(self.dir, f"tmp.step_{step:09d}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        entries = []
        with ThreadPoolExecutor(1) as pool:
            for i, (arr, dtype) in enumerate(host_leaves):
                fn = _leaf_name(i)
                crc = pool.submit(_crc, arr)      # beside the write
                _write_npy(os.path.join(tmp, fn), arr, dtype)
                entries.append({"file": fn, "shape": list(arr.shape),
                                "dtype": dtype, "crc": crc.result()})
                stats["bytes"] += arr.nbytes
                del arr
        manifest = {"step": step, "n_leaves": len(entries),
                    "treedef": treedef, "leaves": entries}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)
        self._gc()
        stats["write_s"] = time.perf_counter() - t_all

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep_n] if self.keep_n else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:09d}"),
                          ignore_errors=True)

    # ---------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and os.path.exists(
                    os.path.join(self.dir, name, "manifest.json")):
                out.append(int(name[len("step_"):]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, state_like, step: int | None = None,
                shardings=None, strict_crc: bool = True, device=None):
        """Rebuild ``state_like``'s tree from disk; returns (state, step).

        A leaf of ``state_like`` that is a tensor is filled in place
        (``copy_``, which casts to its dtype); a leaf on the ``meta``
        device becomes a new tensor of the file's dtype on its sharding's
        device (``shardings``: a tree like the state's of
        ``dist.rules.param_shardings``), else on ``device`` (default
        ``cuda``). A checkpoint written on one device restores onto
        another (elastic restore). With ``shardings`` over the ranks of a
        mesh, each rank keeps its cut of every leaf (the sharding's
        ``local``; ``state_like`` holds the whole shapes, or the rank's
        shards to fill); a checkpoint of any mesh restores on any other.

        Raises:
            FileNotFoundError: no checkpoint in the directory.
            ValueError: the leaf count or a leaf's shape differs.
            IOError: a leaf's CRC32 differs from the manifest's
                (``strict_crc``).
        """
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:09d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        leaves_like = tree_leaves(state_like)
        if len(leaves_like) != manifest["n_leaves"]:
            raise ValueError(
                f"checkpoint has {manifest['n_leaves']} leaves, "
                f"state has {len(leaves_like)}")
        shard_leaves = (tree_leaves(shardings) if shardings is not None
                        else [None] * len(leaves_like))
        self.stats["restore"] = stats = {"step": step, "read_s": 0.0,
                                         "crc_s": 0.0, "load_s": 0.0,
                                         "bytes": 0}
        t0 = time.perf_counter()
        out = []
        files = [os.path.join(path, e["file"]) for e in manifest["leaves"]]
        with ThreadPoolExecutor(1) as pool:
            nxt = pool.submit(_read, files[0]) if files else None
            for i, (like, entry) in enumerate(zip(leaves_like,
                                                  manifest["leaves"])):
                arr, read_s = nxt.result()
                stats["read_s"] += read_s
                if i + 1 < len(files):          # read ahead on the thread
                    nxt = pool.submit(_read, files[i + 1])
                if like.device.type != "meta":
                    dev = like.device
                elif shard_leaves[i] is not None:
                    dev = shard_leaves[i].device
                else:
                    dev = resolve_device(device)
                out.append(self._place(arr, like, entry, step, i, dev,
                                       strict_crc, stats, shard_leaves[i]))
                del arr
        stats["call_s"] = time.perf_counter() - t0
        return tree_unflatten(state_like, out), step

    @staticmethod
    def _place(arr, like, entry, step, i, dev, strict_crc, stats,
               sharding=None):
        """Leaf ``i``'s array checked against the manifest and ``like``,
        as a tensor (the rank's slice under ``sharding``): ``like``
        filled in place when it is a tensor, else a new tensor on
        ``dev``."""
        t = time.perf_counter()
        if strict_crc and _crc(arr) != entry["crc"]:
            raise IOError(f"crc mismatch in {entry['file']} @ step {step}")
        stats["crc_s"] += time.perf_counter() - t
        host = _from_host(arr, entry["dtype"])
        got = tuple(arr.shape)
        if sharding is not None and like.device.type != "meta":
            got = sharding.shard_shape(got)     # like: the rank's shard
        if got != tuple(like.shape):
            raise ValueError(f"shape mismatch leaf {i}: "
                             f"{got} vs {tuple(like.shape)}")
        t = time.perf_counter()
        if sharding is not None:
            part = sharding.local(host)
            if part.shape != host.shape:
                host = part.contiguous()
        if like.device.type != "meta":
            with torch.no_grad():
                like.copy_(host)
            out = like
        else:
            out = host.to(dev)
        if out.device.type == "cuda":
            torch.cuda.synchronize(out.device)
        stats["load_s"] += time.perf_counter() - t
        stats["bytes"] += arr.nbytes
        return out
