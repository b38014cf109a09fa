"""The kernel build's file lock, on the CPU with a stub compiler: ranks
that start together build each library once and the others load it; a
failed build leaves no lock behind. (The real ``nvcc`` builds run on the
card: chip_smoke.py phase ``build``.)"""
import os
import stat
import sys
import threading

import pytest

from repro_torch.kernels import build

STUB = """#!{python}
import sys, time
args = sys.argv[1:]
with open({calls!r}, "a") as fh:
    fh.write("built\\n")
time.sleep(0.4)
if {fail!r}:
    sys.exit(3)
with open(args[args.index("-o") + 1], "w") as fh:
    fh.write("stub library")
"""


class _Loaded:
    def __init__(self, name, path, build_seconds, ptxas_log):
        self.name, self.path = name, path
        self.build_seconds = build_seconds


@pytest.fixture
def stub_build(tmp_path, monkeypatch):
    """``build`` with its directory under ``tmp_path``, a stub ``nvcc``
    that counts its runs, and libraries that are never dlopened."""
    calls = tmp_path / "calls.txt"
    compiler = tmp_path / "nvcc"

    def use(fail=False):
        compiler.write_text(STUB.format(python=sys.executable,
                                        calls=str(calls), fail=fail))
        compiler.chmod(compiler.stat().st_mode | stat.S_IEXEC)

    use()
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "find_nvcc", lambda: str(compiler))
    monkeypatch.setattr(build, "KernelLibrary", _Loaded)
    monkeypatch.setattr(build, "_LOADED", {})

    def runs():
        return len(calls.read_text().splitlines()) if calls.exists() else 0

    return use, runs


def test_concurrent_builds_build_once(stub_build):
    _, runs = stub_build
    ranks = 4
    start = threading.Barrier(ranks)
    got, errors = [None] * ranks, []

    def rank(r):
        try:
            start.wait(timeout=30)
            got[r] = build.build_libraries(("assign", "scan"))
        except Exception as e:                 # noqa: BLE001 - asserted
            errors.append(e)

    workers = [threading.Thread(target=rank, args=(r,)) for r in
               range(ranks)]
    for w in workers:
        w.start()
    for w in workers:
        w.join(timeout=60)
    assert not any(w.is_alive() for w in workers)
    assert not errors
    assert runs() == 2                          # one build a library
    for libs in got:
        assert sorted(libs) == ["assign", "scan"]
        assert all(lib.path.is_file() for lib in libs.values())
    names = sorted(os.listdir(build.BUILD_DIR))
    assert sum(n.endswith(".so") for n in names) == 2   # no temporaries


def test_failed_build_releases_the_lock(stub_build):
    use, runs = stub_build
    use(fail=True)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        build.build_libraries(("router",))
    use(fail=False)
    libs = build.build_libraries(("router",))      # would hang if locked
    assert libs["router"].path.is_file() and runs() == 2
    _, lib, _ = build._paths("router")
    with build.build_lock(lib):                    # free again
        pass
