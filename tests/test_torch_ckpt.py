"""The port's data pipeline (``repro_torch.data.pipeline``) and checkpoint
manager (``repro_torch.ckpt``) against the JAX package's, on the CPU.

* ``SyntheticLM`` bit-equal to the reference's for token, codebook
  (musicgen) and embedding (internvl2) inputs over several seeds and
  batch indices; ``sfc_batch_order`` equal; ``Prefetcher``'s order and
  its swallowed producer exception.
* The reference's own checkpoint tests (tests/test_train_substrate.py)
  on the port: round trip and GC, torn write, CRC, async, elastic.
* The on-disk format: a port-written checkpoint is the reference's byte
  for byte (manifest included) in float32 and bfloat16; the port
  restores the reference's checkpoints equal to the reference's own
  restore, bfloat16 ones included, which the reference cannot restore
  (ROADMAP.md queue 3 item 20); the reference restores a port-written
  float32 checkpoint.

Exact equality throughout: no arithmetic happens between the packages.
"""
import dataclasses
import os
import threading

import jax
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.ckpt.manager import CheckpointManager as RefCheckpointManager
from repro.data import pipeline as RP
from repro.train import TrainHParams as RTrainHParams
from repro.train import init_train_state as ref_init_train_state
from repro_torch import configs
from repro_torch.ckpt import CheckpointManager
from repro_torch.ckpt.manager import treedef_str
from repro_torch.convert import train_state_from_numpy
from repro_torch.data import Prefetcher, SyntheticLM, sfc_batch_order
from repro_torch.dist.rules import param_shardings, resolve_rules
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.optim.adamw import tree_leaves
from repro_torch.train import (TrainHParams, abstract_train_state,
                               train_state_logical_specs)

GRANITE = "granite_moe_3b_a800m"
JAMBA = "jamba_1p5_large_398b"
LLAMA4 = "llama4_maverick_400b_a17b"


def _same(got: torch.Tensor, want) -> bool:
    """Equal bits, dtype and shape (bfloat16 compared as its words)."""
    want = np.asarray(want)
    if want.dtype.name == "bfloat16":
        return got.dtype == torch.bfloat16 and np.array_equal(
            got.view(torch.int16).numpy(), want.view(np.int16))
    return (str(got.dtype).rsplit(".", 1)[-1] == want.dtype.name
            and np.array_equal(got.numpy(), want))


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["gemma3_1b", "musicgen_large",
                                  "internvl2_76b"])
@pytest.mark.parametrize("seed", [0, 4, 17])
def test_synthetic_lm_matches_reference(arch, seed):
    """Tokens, codebooks and embeddings: the first four batches bit-equal
    to the reference's, key for key."""
    cfg = configs.get_config(arch, smoke=True)
    rcfg = ref_configs.get_config(arch, smoke=True)
    got, want = iter(SyntheticLM(cfg, 3, 20, seed)), \
        iter(RP.SyntheticLM(rcfg, 3, 20, seed))
    for _ in range(4):
        g, w = next(got), next(want)
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape
            np.testing.assert_array_equal(g[k], w[k])


def test_synthetic_lm_deterministic():
    """The reference's test on the port: a seed gives the same batch, in
    range, with next-token labels."""
    cfg = configs.get_config("gemma3_1b", smoke=True)
    a = next(iter(SyntheticLM(cfg, 2, 16, seed=4)))
    b = next(iter(SyntheticLM(cfg, 2, 16, seed=4)))
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert a["tokens"].max() < cfg.vocab_size
    np.testing.assert_array_equal(a["tokens"][:, 1:], a["labels"][:, :-1])


@pytest.mark.parametrize("d,n,batch", [(2, 1024, 32), (3, 1000, 64),
                                       (2, 77, 10)])
def test_sfc_batch_order_matches_reference(d, n, batch):
    pts = np.random.default_rng(n).uniform(0, 1, (n, d))
    got, want = sfc_batch_order(pts, batch), RP.sfc_batch_order(pts, batch)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_sfc_batch_order_locality(rng):
    """The reference's test on the port: Hilbert batches are far more
    compact than random ones."""
    pts = rng.uniform(0, 1, (1024, 2))
    batches, rest = sfc_batch_order(pts, 32)
    assert batches.shape == (32, 32) and rest.size == 0

    def spread(idx):
        return np.mean(np.ptp(pts[idx], axis=0))
    sfc_spread = np.mean([spread(b) for b in batches])
    rnd_spread = np.mean([spread(rng.permutation(1024)[:32])
                          for _ in range(32)])
    assert sfc_spread < 0.5 * rnd_spread


@pytest.mark.parametrize("cls", [Prefetcher, RP.Prefetcher],
                         ids=["port", "reference"])
def test_prefetcher_order_and_swallowed_exception(cls, monkeypatch):
    """Items come in order; an exception in the producer ends the stream
    with ``StopIteration`` after the items before it (the reference's
    ``finally``), in both packages."""
    assert list(cls(range(7))) == list(range(7))

    def broken():
        yield from range(3)
        raise RuntimeError("producer failed")

    seen = []
    monkeypatch.setattr(threading, "excepthook",
                        lambda args: seen.append(args.exc_type))
    p = cls(broken())
    assert list(p) == [0, 1, 2]
    p._thread.join(timeout=10)
    assert not p._thread.is_alive() and seen == [RuntimeError]


# ---------------------------------------------------------------------------
# the reference's checkpoint tests, on the port
# ---------------------------------------------------------------------------

def test_ckpt_roundtrip_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_n=2)
    state = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
             "b": {"c": torch.tensor(7, dtype=torch.int32)}}
    for s in (1, 2, 3):
        mgr.save(s, {"a": state["a"] + s, "b": {"c": state["b"]["c"] + s}})
    assert mgr.all_steps() == [2, 3]         # keep_n GC
    restored, step = mgr.restore(state)
    assert step == 3
    np.testing.assert_allclose(restored["a"].numpy(),
                               np.arange(6).reshape(2, 3) + 3)
    assert int(restored["b"]["c"]) == 10
    assert restored["a"] is state["a"]       # filled in place


def test_ckpt_torn_write_ignored(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_n=5)
    state = {"a": torch.ones(3)}
    mgr.save(1, state)
    os.makedirs(tmp_path / "step_000000002")
    (tmp_path / "step_000000002" / "leaf_00000.npy").write_bytes(b"junk")
    os.makedirs(tmp_path / "tmp.step_000000003")
    assert mgr.latest_step() == 1


def test_ckpt_crc_detects_corruption(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    state = {"a": torch.ones(64)}
    mgr.save(1, state)
    f = tmp_path / "step_000000001" / "leaf_00000.npy"
    raw = bytearray(f.read_bytes())
    raw[-1] ^= 0xFF
    f.write_bytes(bytes(raw))
    with pytest.raises(IOError):
        mgr.restore(state)
    restored, _ = mgr.restore({"a": torch.zeros(64)}, strict_crc=False)
    assert float(restored["a"][0]) == 1.0


def test_ckpt_async_snapshot_is_complete_when_save_returns(tmp_path):
    """The files are written on a worker thread; the step after the save
    may update the state in place at once."""
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    state = {"a": torch.full((1 << 16,), 3.0)}
    mgr.save(5, state)
    state["a"].add_(1.0)                    # the next step, in place
    mgr.wait()
    restored, step = mgr.restore({"a": torch.empty(1 << 16,
                                                   device="meta")},
                                 device="cpu")
    assert step == 5
    np.testing.assert_array_equal(restored["a"].numpy(), 3.0)
    assert mgr.stats["save"]["bytes"] == 4 << 16


def test_ckpt_elastic_restore(tmp_path):
    """The elastic path on one rank: a meta state restored onto the
    shardings' device (``param_shardings`` on a one-rank mesh) or onto
    ``device``; the values and dtypes of the checkpoint."""
    mgr = CheckpointManager(str(tmp_path))
    state = {"w": torch.arange(8, dtype=torch.float32),
             "b": torch.arange(4, dtype=torch.float64).bfloat16()}
    mgr.save(1, state)
    like = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
            for k, v in state.items()}
    rules = resolve_rules(make_host_mesh(device="cpu"),
                          configs.get_config(GRANITE, smoke=True), "train")
    sh = param_shardings(rules, {"w": ("embed",), "b": (None,)})
    assert sh["w"].spec == ("data",) and sh["w"].device.type == "cpu"
    for kw in ({"shardings": sh}, {"device": "cpu"}):
        restored, _ = mgr.restore(like, **kw)
        for k in state:
            assert restored[k].device.type == "cpu"
            assert restored[k].dtype == state[k].dtype
            assert torch.equal(restored[k], state[k])


def test_ckpt_restore_errors(tmp_path):
    """What the reference raises: no checkpoint, another leaf count,
    another shape."""
    mgr = CheckpointManager(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        mgr.restore({"a": torch.zeros(2)})
    mgr.save(1, {"a": torch.zeros(2), "b": torch.zeros(3)})
    with pytest.raises(ValueError, match="leaves"):
        mgr.restore({"a": torch.zeros(2)})
    with pytest.raises(ValueError, match="shape mismatch leaf 1"):
        mgr.restore({"a": torch.zeros(2), "b": torch.zeros(4)})


def test_restore_into_meta_needs_the_card_by_default(tmp_path):
    """A meta leaf with no sharding and no device goes to the card: on a
    machine without one, restore raises rather than falling back."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"a": torch.zeros(2)})
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mgr.restore({"a": torch.empty(2, device="meta")})


# ---------------------------------------------------------------------------
# the on-disk format against the reference's
# ---------------------------------------------------------------------------

def _cfgs(arch, bf16=False):
    """(reference, port) SMOKE configs of ``arch``; with ``bf16`` their
    parameters and moments in bfloat16, as jamba's and llama4's CONFIGs
    have them."""
    out = (ref_configs.get_config(arch, smoke=True),
           configs.get_config(arch, smoke=True))
    if bf16:
        out = tuple(dataclasses.replace(c, param_dtype="bfloat16",
                                        moment_dtype="bfloat16")
                    for c in out)
    return out


def _ref_state(arch, compress="none", bf16=False):
    """The reference's initial SMOKE train state of ``arch`` and the port's
    copy of it."""
    rstate = ref_init_train_state(_cfgs(arch, bf16)[0],
                                  jax.random.PRNGKey(0),
                                  RTrainHParams(grad_compress=compress))
    return rstate, train_state_from_numpy(jax.tree.map(np.asarray, rstate),
                                          "cpu")


def _files(path):
    return {f: (path / f).read_bytes() for f in sorted(os.listdir(path))}


@pytest.mark.parametrize("arch,compress,bf16", [(GRANITE, "none", False),
                                                (GRANITE, "bf16", False),
                                                (LLAMA4, "none", True)])
def test_port_writes_the_reference_bytes(arch, compress, bf16, tmp_path):
    """Every file of a port-written checkpoint (leaves and manifest) is the
    reference's byte for byte: float32, int32, and bfloat16 leaves under
    numpy's ``'<V2'`` header."""
    rstate, pstate = _ref_state(arch, compress, bf16)
    assert any(x.dtype == torch.bfloat16
               for x in tree_leaves(pstate)) == bf16
    RefCheckpointManager(str(tmp_path / "ref")).save(3, rstate)
    CheckpointManager(str(tmp_path / "port")).save(3, pstate)
    want = _files(tmp_path / "ref" / "step_000000003")
    got = _files(tmp_path / "port" / "step_000000003")
    assert len(want) == len(tree_leaves(pstate)) + 1
    assert got.keys() == want.keys()
    for name in want:
        assert got[name] == want[name], name
    assert treedef_str(pstate) == str(jax.tree.flatten(rstate)[1])


@pytest.mark.parametrize("arch,compress,bf16", [(GRANITE, "none", False),
                                                (GRANITE, "int8", False),
                                                (JAMBA, "none", True),
                                                (LLAMA4, "bf16", True)])
def test_port_restores_reference_checkpoints(arch, compress, bf16,
                                             tmp_path):
    """The port restores a reference-written checkpoint into
    ``abstract_train_state`` (meta) on the CPU, equal leaf for leaf to the
    state the reference saved; for float32 states also to the reference's
    own restore. bfloat16 parameters and moments (jamba's and llama4's
    CONFIG dtypes): the reference's restore raises ``TypeError``
    (ROADMAP.md queue 3 item 20), the port's reads them."""
    rstate, _ = _ref_state(arch, compress, bf16)
    RefCheckpointManager(str(tmp_path)).save(2, rstate)
    like = abstract_train_state(_cfgs(arch, bf16)[1],
                                TrainHParams(grad_compress=compress))
    got, step = CheckpointManager(str(tmp_path)).restore(like, device="cpu")
    assert step == 2
    want = jax.tree.leaves(rstate)
    assert len(tree_leaves(got)) == len(want)
    for g, w in zip(tree_leaves(got), want):
        assert _same(g, w)
    assert any(np.asarray(w).dtype.name == "bfloat16"
               for w in want) == bf16
    ref = RefCheckpointManager(str(tmp_path))
    if bf16:
        with pytest.raises(TypeError, match="V2"):
            ref.restore(rstate)
    else:
        rgot, _ = ref.restore(rstate)
        for g, w in zip(tree_leaves(got), jax.tree.leaves(rgot)):
            assert _same(g, w)


def test_reference_restores_a_port_checkpoint(tmp_path):
    """A float32 checkpoint of the port's state (after an in-place change)
    restores in the reference, equal leaf for leaf."""
    rstate, pstate = _ref_state(GRANITE)
    pstate["params"]["final_norm"]["scale"].mul_(3.0)
    pstate["opt"]["step"].fill_(9)
    CheckpointManager(str(tmp_path)).save(9, pstate)
    got, step = RefCheckpointManager(str(tmp_path)).restore(rstate)
    assert step == 9
    for g, p in zip(jax.tree.leaves(got), tree_leaves(pstate)):
        assert _same(p, g)
    assert int(got["opt"]["step"]) == 9


@pytest.mark.parametrize("arch", [GRANITE, "gemma3_1b"])
def test_restore_fills_a_live_state_in_place(arch, tmp_path):
    """Leaves that are tensors are filled with ``copy_`` (the same tensor
    objects come back), parameters that require grad included."""
    _, pstate = _ref_state(arch)
    CheckpointManager(str(tmp_path)).save(1, pstate)
    _, live = _ref_state(arch)
    for x in tree_leaves(live):
        x.zero_()
    for p in tree_leaves(live["params"]):
        p.requires_grad_(True)
    before = [id(x) for x in tree_leaves(live)]
    got, _ = CheckpointManager(str(tmp_path)).restore(live)
    assert [id(x) for x in tree_leaves(got)] == before
    for g, w in zip(tree_leaves(got), tree_leaves(pstate)):
        assert torch.equal(g.detach(), w)


def test_logical_specs_cover_the_checkpointed_state():
    """``train_state_logical_specs`` has a tuple for every leaf of the
    state, of the leaf's rank: what ``param_shardings`` places on a
    restore."""
    cfg = configs.get_config(GRANITE, smoke=True)
    hp = TrainHParams(grad_compress="bf16")
    specs = train_state_logical_specs(cfg, hp)
    leaves = tree_leaves(abstract_train_state(cfg, hp))

    def spec_leaves(t):
        if isinstance(t, dict):
            return [x for k in sorted(t) for x in spec_leaves(t[k])]
        return [t]
    got = spec_leaves(specs)
    assert len(got) == len(leaves)
    assert all(len(s) == x.dim() for s, x in zip(got, leaves))
