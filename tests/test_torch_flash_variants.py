"""``tools/flash_variants.py`` against the kernels' current sources: each
line that ``tune``, ``tune32``, a mutant or a what-if copy edits occurs
exactly once in the source it edits, so that the tool neither stops on
the card nor edits the wrong line after a kernel changes, and each edit
makes the copy it describes."""
import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
_SPEC = importlib.util.spec_from_file_location(
    "flash_variants", ROOT / "tools" / "flash_variants.py")
fv = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(fv)


def _source(path):
    return (ROOT / path).read_text()


@pytest.mark.parametrize("path,key", [
    *((fv.KERNEL, k) for k in fv.SHAPE_LINES),
    *((fv.KERNEL32, k) for k in fv.SHAPE_LINES_F32),
])
def test_tune_lines_occur_once(path, key):
    lines = fv.SHAPE_LINES if path == fv.KERNEL else fv.SHAPE_LINES_F32
    assert _source(path).count(lines[key]) == 1


@pytest.mark.parametrize("name", sorted(fv.MUTANTS))
def test_mutant_anchors_occur_once(name):
    path, old, new = fv.MUTANTS[name]
    assert _source(path).count(old) == 1
    assert old != new


@pytest.mark.parametrize("name", sorted(fv.WHATIF))
def test_whatif_anchors_occur_once(name):
    text = _source(fv.KERNEL32)
    for old, new in fv.WHATIF[name]:
        assert text.count(old) == 1 and old != new


@pytest.mark.parametrize("name", ["f32alpha", "f32droptile"])
def test_float32_mutants_edit_the_float32_kernel(name):
    assert fv.MUTANTS[name][0] == fv.KERNEL32


@pytest.mark.parametrize("spec,want", [
    ("base:128:64:4", ("NW = DH <= 64 ? 4 :", "RM = DH <= 64 ? 8 :",
                       "BK = DH <= 64 ? 64 :")),
    ("wide:256:64:8", ("NW = DH <= 64 ? 8 :", "RM = DH <= 64 ? 8 :",
                       "BK = DH <= 64 ? 64 :")),
    ("half:64:32:4", ("NW = DH <= 64 ? 4 :", "RM = DH <= 64 ? 4 :",
                      "BK = DH <= 64 ? 32 :")),
])
def test_tune32_rewrites_each_tile_line_once(spec, want):
    """Applied to the current source, every edit of a spec replaces one
    line and leaves the dh > 64 instances' shapes as they are."""
    text = _source(fv.KERNEL32)
    edits = fv.tune32_edits(spec)
    assert len(edits) == len(fv.SHAPE_LINES_F32) - 1   # UNROLL kept
    for path, old, new in edits:
        assert path == fv.KERNEL32 and text.count(old) == 1
        text = text.replace(old, new)
    for w in want:
        assert text.count(w) == 1
    assert "NW = DH <= 64 ? " in text and "(DH <= 128 ? 64 : 32)" in text


def test_tune32_sets_the_unroll_factor_when_given():
    text = _source(fv.KERNEL32)
    edits = fv.tune32_edits("u4:128:64:4:4")
    assert len(edits) == len(fv.SHAPE_LINES_F32)
    for _, old, new in edits:
        assert text.count(old) == 1
        text = text.replace(old, new)
    assert text.count("UNROLL = DH <= 64 ? 4 : 8;") == 1


def test_tune32_refuses_a_block_the_warps_do_not_divide():
    for spec in ("odd:80:64:4", "wide:512:64:4", "ragged:100:64:4"):
        with pytest.raises(SystemExit, match="rows a thread"):
            fv.tune32_edits(spec)


def test_tune_rewrites_each_shape_line_once():
    text = _source(fv.KERNEL)
    for path, old, new in fv.tune_edits("pp:2:128:4:true"):
        assert path == fv.KERNEL and text.count(old) == 1
        text = text.replace(old, new)
    assert "NWG == 2 && BK == 128 && true;" in text
