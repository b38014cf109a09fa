"""The port's abstract shapes, logical specs and sharding rules against the
JAX package's, for all ten configs on the CPU:

* ``models.model``: ``abstract_params`` (``meta`` tensors against the
  reference's ``ShapeDtypeStruct`` tree), ``param_logical_specs`` and
  ``cache_logical_specs`` (whose tree is ``init_cache``'s);
* ``train.step``: ``abstract_train_state`` and
  ``train_state_logical_specs``, with and without compression;
* ``launch.shapes``: ``input_specs`` and ``batch_logical_specs`` of every
  shape cell;
* ``dist.rules``: ``resolve_rules`` tables of the four phases, with and
  without ``batch_size`` and overrides, on ``(data, model)`` and ``(pod,
  data, model)`` meshes; ``Rules.spec`` / ``sharding`` / ``shard`` and
  ``param_shardings``; ``configs.sharding_overrides``;
* ``launch.mesh.make_host_mesh``: one rank only (ROADMAP.md queue 1 item
  4.9).

Shapes, dtypes and names are compared exactly.
"""
import jax
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.dist import rules as RR
from repro.launch import shapes as RS
from repro.launch.mesh import make_compat_mesh
from repro.models import model as RM
from repro.train import TrainHParams as RTrainHParams
from repro.train.step import abstract_train_state as ref_abstract_state
from repro.train.step import \
    train_state_logical_specs as ref_state_specs
from repro_torch import configs
from repro_torch.dist import rules as R
from repro_torch.launch import shapes as S
from repro_torch.launch.mesh import Mesh, make_host_mesh
from repro_torch.models import model as M
from repro_torch.optim.adamw import tree_leaves
from repro_torch.train import (TrainHParams, abstract_train_state,
                               train_state_logical_specs)

CPU = torch.device("cpu")


def _is_spec(x):
    return isinstance(x, tuple)


def _dtype(x) -> str:
    return str(x.dtype).rsplit(".", 1)[-1]


def _assert_abstract(got, want):
    """``got`` (meta tensors) has ``want``'s keys, shapes and dtypes."""
    paths = jax.tree_util.tree_flatten_with_path(want)[0]
    leaves = tree_leaves(got)
    assert len(leaves) == len(paths)
    for (path, w), g in zip(paths, leaves):
        name = jax.tree_util.keystr(path)
        assert g.device.type == "meta", name
        assert tuple(g.shape) == tuple(w.shape), name
        assert _dtype(g) == str(np.dtype(w.dtype)), name


def _spec_tree(t):
    """A tree of logical tuples as nested dicts of lists (comparable across
    the packages: the reference's trees hold tuples too)."""
    if isinstance(t, dict):
        return {k: _spec_tree(v) for k, v in t.items()}
    assert _is_spec(t), t
    return list(t)


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_abstract_params_and_specs_match_reference(arch):
    """``abstract_params`` as meta tensors of the reference's shapes and
    dtypes (CONFIG: nothing allocated, however large); the logical specs
    of the parameters and of the decode cache equal, the cache's in
    ``init_cache``'s tree."""
    for smoke in (True, False):
        cfg = configs.get_config(arch, smoke=smoke)
        rcfg = ref_configs.get_config(arch, smoke=smoke)
        _assert_abstract(M.abstract_params(cfg), RM.abstract_params(rcfg))
        assert _spec_tree(M.param_logical_specs(cfg)) == \
            _spec_tree(RM.param_logical_specs(rcfg))
        assert _spec_tree(M.cache_logical_specs(cfg)) == \
            _spec_tree(RM.cache_logical_specs(rcfg))
    cfg = configs.get_config(arch, smoke=True)
    cache = M.init_cache(cfg, 2, 16, device="cpu")
    specs = M.cache_logical_specs(cfg)
    assert cache.keys() == specs.keys()
    for pos in cache:
        assert cache[pos].keys() == specs[pos].keys()
        for k, x in cache[pos].items():
            assert len(specs[pos][k]) == x.dim(), (pos, k)


@pytest.mark.parametrize("compress", ["none", "int8"])
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_abstract_train_state_matches_reference(arch, compress):
    """Every leaf's shape and dtype at CONFIG widths (bfloat16 moments of
    jamba and llama4, the influence of granite and llama4, the residuals
    with compression) and every leaf's logical axes."""
    cfg = configs.get_config(arch)
    rcfg = ref_configs.get_config(arch)
    hp, rhp = TrainHParams(grad_compress=compress), \
        RTrainHParams(grad_compress=compress)
    got = abstract_train_state(cfg, hp)
    want = ref_abstract_state(rcfg, rhp)
    assert got.keys() == want.keys()
    _assert_abstract(got, want)
    assert _spec_tree(train_state_logical_specs(cfg, hp)) == \
        _spec_tree(ref_state_specs(rcfg, rhp))


@pytest.mark.parametrize("cell", sorted(S.SHAPES))
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_input_specs_match_reference(arch, cell):
    cfg, rcfg = configs.get_config(arch), ref_configs.get_config(arch)
    assert S.SHAPES[cell] == S.ShapeCell(*vars(RS.SHAPES[cell]).values())
    got = S.input_specs(cfg, S.SHAPES[cell])
    want = RS.input_specs(rcfg, RS.SHAPES[cell])
    assert got.keys() == want.keys()
    _assert_abstract(got, want)
    assert _spec_tree(S.batch_logical_specs(cfg, S.SHAPES[cell])) == \
        _spec_tree(RS.batch_logical_specs(rcfg, RS.SHAPES[cell]))


# ---------------------------------------------------------------------------
# sharding rules
# ---------------------------------------------------------------------------

MESHES = {"1x1": ((1, 1), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "pod2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
OVERRIDES = {"none": None,
             "moe": {"expert": "data", "act_batch": ("pod", "data"),
                     "heads": ("pod",), "vocab": None}}


@pytest.mark.parametrize("overrides", sorted(OVERRIDES))
@pytest.mark.parametrize("batch", [None, 4, 6])
@pytest.mark.parametrize("phase", ["train", "prefill", "decode",
                                   "long_decode"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_resolve_rules_matches_reference(mesh, phase, batch, overrides):
    """The resolved table equals the reference's: the phase rule, the drop
    of batch parallelism when the batch does not divide (6 over the pod
    mesh's 4), the overrides, the drop of axes the mesh lacks ("pod" on a
    two-axis mesh)."""
    shape, axes = MESHES[mesh]
    rcfg = ref_configs.get_config("granite_moe_3b_a800m", smoke=True)
    cfg = configs.get_config("granite_moe_3b_a800m", smoke=True)
    want = RR.resolve_rules(make_compat_mesh(shape, axes), rcfg, phase,
                            batch_size=batch,
                            overrides=OVERRIDES[overrides])
    got = R.resolve_rules(Mesh(axes, shape, CPU), cfg, phase,
                          batch_size=batch, overrides=OVERRIDES[overrides])
    assert got.table == dict(want.table)
    assert got.phase == want.phase == phase
    for logical in (("act_batch", None), ("repeat", "embed", "mlp"),
                    ("nil", "vocab", "embed"), ("unknown", "expert")):
        assert got.spec(*logical) == tuple(want.spec(*logical))


def test_resolve_rules_refuses_an_unknown_phase():
    cfg = configs.get_config("gemma3_1b", smoke=True)
    with pytest.raises(ValueError, match="unknown phase"):
        R.resolve_rules(make_host_mesh(device="cpu"), cfg, "serve")


def test_rules_on_one_rank():
    """``shard`` checks the names against the rank and returns the tensor
    itself; ``sharding`` and ``param_shardings`` carry the spec and the
    rank's device for every parameter of the tree."""
    cfg = configs.get_config("gemma3_1b", smoke=True)
    rules = R.resolve_rules(make_host_mesh(device="cpu"), cfg, "train")
    x = torch.zeros(2, 3)
    assert rules.shard(x, "act_batch", "act_embed") is x
    with pytest.raises(AssertionError, match="rank-2"):
        rules.shard(x, "act_batch")
    specs = M.param_logical_specs(cfg)
    sh = R.param_shardings(rules, specs)

    def pairs(s, t):
        if isinstance(s, dict):
            return [p for k in sorted(s) for p in pairs(s[k], t[k])]
        return [(s, t)]
    got = pairs(specs, sh)
    assert len(got) == len(tree_leaves(M.abstract_params(cfg)))
    for spec, sharding in got:
        assert sharding.spec == rules.spec(*spec)
        assert sharding.device == CPU and sharding.mesh is rules.mesh
    assert rules.sharding(("embed", "vocab")).spec == ("data", "model")


@pytest.mark.parametrize("data,model", [(2, 1), (1, 2), (4, 4)])
def test_make_host_mesh_is_one_rank(data, model):
    """The default mesh is one rank. Any ``(data, model)`` mesh is a mesh
    of that shape (data ranks since ROADMAP.md queue 1 item 4.9, the
    model axis for serving since the serving half of item 4.10), its
    communicator bound only inside a rank: outside one it raises."""
    mesh = make_host_mesh(device="cpu")
    assert mesh.axis_names == ("data", "model")
    assert mesh.shape == {"data": 1, "model": 1}
    assert mesh.comm is None
    mesh = make_host_mesh(data, model, device="cpu")
    assert mesh.axis_names == ("data", "model")
    assert mesh.shape == {"data": data, "model": model}
    assert mesh.size == data * model
    with pytest.raises(RuntimeError, match="outside a rank"):
        mesh.comm
    with pytest.raises(ValueError, match=">= 1"):
        make_host_mesh(data, 0, device="cpu")


def test_make_host_mesh_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_host_mesh()


@pytest.mark.parametrize("mode", ["train", "prefill", "decode",
                                  "long_decode"])
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_sharding_overrides_match_reference(arch, mode):
    assert configs.sharding_overrides(arch, mode) == \
        ref_configs.sharding_overrides(arch, mode) == {}
