"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package ``repro``, anywhere in
the file (function bodies included)."""
import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "src", "repro_torch")


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PORT):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _forbidden(module: str) -> bool:
    top = module.split(".", 1)[0]
    return top in ("jax", "jaxlib", "repro")


def _imports(path):
    with open(path, encoding="utf-8") as fh:
        tree = ast.parse(fh.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", getattr(node.func, "attr", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.lineno, str(node.args[0].value)


def test_port_has_files():
    files = _port_files()
    assert len(files) > 10
    assert os.path.join(PORT, "kernels", "ops.py") in files


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_reference_import(path):
    bad = [(line, mod) for line, mod in _imports(path) if _forbidden(mod)]
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def test_scanner_catches_nested_imports(tmp_path):
    path = tmp_path / "fixture.py"
    path.write_text(
        "def f():\n    from repro.kernels.ops import x\n"
        "    import jax.numpy as jnp\n"
        "    import importlib; importlib.import_module('repro.core')\n"
        "from repro_torch.kernels import ops\n", encoding="utf-8")
    mods = {m for _, m in _imports(str(path))}
    assert {m for m in mods if _forbidden(m)} == {
        "repro.kernels.ops", "jax.numpy", "repro.core"}
    assert "repro_torch.kernels" in mods
