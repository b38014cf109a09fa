"""Build and load the hand-written CUDA kernels.

Each source in ``kernels/csrc/`` (``assign.cu``, ``scan.cu``,
``router.cu``, ``flash_attention.cu``, ``flash_attention_tc.cu``) is
compiled at first use with ``nvcc`` into a shared library with a plain C
interface and loaded with ``ctypes``; no PyTorch headers are involved, so
a build takes seconds. ``build_libraries`` starts one ``nvcc`` per
missing library, all at once. A library is named by a hash of its source and
flags and kept in ``kernels/_build/`` (listed in ``.gitignore``), so an
edited source is rebuilt and an unchanged one is loaded as it is.

Ranks that start together (``dist.launch``) would all find a library
missing and build it at once. Each build holds an exclusive ``flock`` on
the library's lock file: the first process builds, the others wait and
then load what it built. The kernel drops the lock when a process ends,
so a build cut short leaves no stale lock behind.

Nothing here runs at import: the CPU tests import every module, on
machines that have no CUDA toolkit.
"""
from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# C signatures of the entry points, by library (see the sources)
_SIGNATURES = {
    "assign": {
        "repro_assign_argmin": [_P] * 4 + [_I] * 8 + [_P] * 5,
        "repro_assign_reduce": [_P] * 5 + [_I] * 8 + [_P] * 6,
        "repro_assign_occupancy": [_I, _I, _I, _I, _I, _P],
    },
    "scan": {
        "repro_prefix_sum_f64": [_P, _P, _L, _P],
        "repro_f64_add_chain": [_P, ctypes.c_double, _L, _P],
    },
    "router": {
        "repro_router_topk": [_P] * 3 + [_I] * 6 + [_P] * 5,
    },
    "flash_attention": {
        "repro_flash_attention_fwd": [_P] * 4 + [_I] * 5 + [_L] * 12
                                     + [_F, _F, _P],
    },
    "flash_attention_tc": {
        "repro_flash_attention_tc_fwd": [_P] * 4 + [_I] * 5 + [_L] * 12
                                        + [_F, _F, _P],
    },
}
LIBRARIES = tuple(_SIGNATURES)


class KernelLibrary:
    """One loaded library plus what its build reported."""

    def __init__(self, name: str, path: Path, build_seconds: float,
                 ptxas_log: str):
        self.name = name
        self.path = path
        self.build_seconds = build_seconds
        self.ptxas_log = ptxas_log
        self._lib = ctypes.CDLL(str(path))
        for fn_name, argtypes in _SIGNATURES[name].items():
            fn = getattr(self._lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        self._lib.repro_error_name.argtypes = [ctypes.c_int]
        self._lib.repro_error_name.restype = ctypes.c_char_p

    def call(self, name: str, *args) -> None:
        """Call entry point ``name``; raise if the launch was refused."""
        err = getattr(self._lib, name)(*args)
        if err != 0:
            text = self._lib.repro_error_name(err).decode()
            raise RuntimeError(f"{name} failed: CUDA error {err} ({text})")


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(Path(on_path))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                       "the CUDA toolkit (set CUDA_HOME)")


_LOADED: dict[str, KernelLibrary] = {}


def load_library(name: str = "assign") -> KernelLibrary:
    """Build (if needed) and load library ``name``; cached for the
    process."""
    if name not in _LOADED:
        build_libraries((name,))
    return _LOADED[name]


def _paths(name: str) -> tuple[Path, Path, Path]:
    src = CSRC / f"{name}.cu"
    tag = hashlib.sha256(src.read_bytes()
                         + " ".join(FLAGS).encode()).hexdigest()[:12]
    return (src, BUILD_DIR / f"lib{name}_{tag}.so",
            BUILD_DIR / f"lib{name}_{tag}.log")


@contextlib.contextmanager
def build_lock(target: Path):
    """Hold an exclusive lock on ``target``'s lock file (its name plus
    ``.lock``) for the block: one process at a time checks for and builds
    ``target``."""
    with open(f"{target}.lock", "a+") as fh:
        fcntl.flock(fh.fileno(), fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(fh.fileno(), fcntl.LOCK_UN)


def build_libraries(names=LIBRARIES) -> dict[str, KernelLibrary]:
    """Load the libraries ``names``, building the missing ones with one
    ``nvcc`` each, all started together. Each library is checked and
    built under its ``build_lock`` (taken in the order of ``names``), so
    processes that call this at once build every library once. A failed
    build raises after every ``nvcc`` it started has ended."""
    unknown = set(names) - set(_SIGNATURES)
    if unknown:
        raise KeyError(f"unknown kernel libraries {sorted(unknown)}; "
                       f"available: {list(LIBRARIES)}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    pending = {}
    with contextlib.ExitStack() as locks:
        try:
            for name in names:
                if name in _LOADED:
                    continue
                src, lib, log = _paths(name)
                locks.enter_context(build_lock(lib))
                if lib.is_file():
                    _LOADED[name] = KernelLibrary(
                        name, lib, 0.0,
                        log.read_text() if log.is_file() else "")
                    continue
                fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
                os.close(fd)
                proc = subprocess.Popen([find_nvcc(), *FLAGS, "-o", tmp,
                                         str(src)], stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True)
                pending[name] = (proc, tmp, lib, log, time.perf_counter())
            errors = []
            for name, (proc, tmp, lib, log, t0) in pending.items():
                out, err = proc.communicate()
                seconds = time.perf_counter() - t0
                if proc.returncode != 0:
                    os.unlink(tmp)
                    errors.append(f"nvcc failed on {name}.cu "
                                  f"({proc.returncode}):\n{out}\n{err}")
                    continue
                log.write_text(out + err)
                os.replace(tmp, lib)
                _LOADED[name] = KernelLibrary(name, lib, seconds, out + err)
            if errors:
                raise RuntimeError("\n".join(errors))
        finally:
            for proc, tmp, *_ in pending.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                if os.path.exists(tmp):
                    os.unlink(tmp)
    return {name: _LOADED[name] for name in names}
