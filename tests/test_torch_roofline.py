"""The port's roofline arithmetic (``repro_torch.launch.roofline``) against
the reference's (``repro.launch.roofline``): ``model_flops`` bit for bit
for every config and shape cell, ``three_terms`` and ``summarize`` equal
with the reference's constants set to the port's H100 figures, and the
ring accounting of ``collective_wire`` equal to ``parse_collectives`` on
HLO lines of each collective kind and replica-group form."""
import pytest

from repro import configs as ref_configs
from repro.launch import roofline as REF
from repro.launch.shapes import SHAPES as REF_SHAPES

from repro_torch import configs
from repro_torch.launch import roofline as RL
from repro_torch.launch.shapes import SHAPES


def test_shape_cells_are_the_reference_cells():
    assert {k: (c.seq, c.batch, c.mode) for k, c in SHAPES.items()} == {
        k: (c.seq, c.batch, c.mode) for k, c in REF_SHAPES.items()}


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_model_flops_bit_equal(arch, shape):
    cell = SHAPES[shape]
    got = RL.model_flops(configs.get_config(arch), cell.mode, cell.batch,
                         cell.seq)
    want = REF.model_flops(ref_configs.get_config(arch), cell.mode,
                           cell.batch, cell.seq)
    assert got == want and type(got) is type(want)


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_attn_layer_counts_equal(arch):
    assert RL._attn_layer_counts(configs.get_config(arch)) == \
        REF._attn_layer_counts(ref_configs.get_config(arch))


@pytest.fixture
def ref_on_h100(monkeypatch):
    """The reference module with its constants set to the port's."""
    monkeypatch.setattr(REF, "PEAK_FLOPS", RL.PEAK_FLOPS)
    monkeypatch.setattr(REF, "HBM_BW", RL.HBM_BW)
    monkeypatch.setattr(REF, "ICI_BW", RL.NVLINK_BW)
    return REF


def test_constants_are_the_h100_data_sheet():
    assert (RL.PEAK_FLOPS, RL.HBM_BW, RL.NVLINK_BW) == (989e12, 3.35e12,
                                                        450e9)


# (flops, bytes, wire): compute-, memory- and collective-bound, and ties
TERMS = [(1e15, 1e9, 0.0), (1e12, 1e13, 1e9), (1e9, 1e9, 1e12),
         (989e12, 3.35e12, 450e9), (0.0, 0.0, 0.0)]


@pytest.mark.parametrize("terms", TERMS)
def test_three_terms_equal_reference(ref_on_h100, terms):
    assert RL.three_terms(*terms) == ref_on_h100.three_terms(*terms)


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_summarize_equal_reference(ref_on_h100, arch, shape):
    cell = SHAPES[shape]
    args = (cell.mode, cell.batch, cell.seq, 1, 3.5e15, 2.25e12, 1e9)
    assert RL.summarize(configs.get_config(arch), *args) == \
        ref_on_h100.summarize(ref_configs.get_config(arch), *args)


def test_mfu_is_model_flops_over_time_over_peak():
    cfg = configs.get_config("granite_moe_3b_a800m")
    mf = RL.model_flops(cfg, "train", 2, 4096)
    assert RL.mfu(cfg, "train", 2, 4096, 2.0) == mf / 2.0 / 989e12


# HLO lines of every collective kind in each replica-group form the
# reference reads: an explicit list, the iota form [groups, size]<=[N],
# none (the whole mesh), tuple results of the async -start forms
HLO_LINES = [
    "%ag = f32[8,128]{1,0} all-gather(f32[2,128]{1,0} %x), "
    "replica_groups={{0,1,2,3}}, dimensions={0}",
    "%ag2 = bf16[4,64]{1,0} all-gather(bf16[2,64]{1,0} %x), "
    "replica_groups=[4,2]<=[8], dimensions={0}",
    "%ags = (f32[2,128]{1,0}, f32[16,128]{1,0}) all-gather-start("
    "f32[2,128]{1,0} %x), replica_groups={{0,1,2,3,4,5,6,7}}",
    "%ar = f32[1024]{0} all-reduce(f32[1024]{0} %y), "
    "replica_groups={{0,1},{2,3}}, to_apply=%sum",
    "%ar2 = bf16[512,8]{1,0} all-reduce(bf16[512,8]{1,0} %y), "
    "replica_groups=[2,4]<=[8], to_apply=%sum",
    "%ar3 = s32[] all-reduce(s32[] %c), to_apply=%sum",
    "%ars = f32[64]{0} all-reduce-start(f32[64]{0} %y), "
    "replica_groups={{0,1,2,3,4,5,6,7}}, to_apply=%sum",
    "%rs = f32[256]{0} reduce-scatter(f32[1024]{0} %z), "
    "replica_groups={{0,1,2,3}}, dimensions={0}, to_apply=%sum",
    "%rs2 = bf16[32,16]{1,0} reduce-scatter(bf16[256,16]{1,0} %z), "
    "replica_groups=[1,8]<=[8], dimensions={0}, to_apply=%sum",
    "%a2a = f32[4,64]{1,0} all-to-all(f32[4,64]{1,0} %w), "
    "replica_groups={{0,1,2,3}}, dimensions={0}",
    "%a2a2 = s8[8,8]{1,0} all-to-all(s8[8,8]{1,0} %w), "
    "replica_groups=[4,2]<=[8], dimensions={0}",
    "%cp = f32[128]{0} collective-permute(f32[128]{0} %v), "
    "source_target_pairs={{0,1},{1,0}}",
    "%cps = (f32[32]{0}, f32[32]{0}) collective-permute-start("
    "f32[32]{0} %v), source_target_pairs={{0,1}}",
    "%one = f32[16]{0} all-reduce(f32[16]{0} %u), replica_groups={{0}}, "
    "to_apply=%sum",
]


def _as_records(lines, n_devices):
    """The (kind, result_bytes, group_size) the port takes, read from each
    line with the reference's own parsers."""
    out = []
    for line in lines:
        m = REF._COLL_RE.search(line)
        out.append((m.group("op"), REF._shape_bytes(m.group("rtype")),
                    REF._group_size(line, n_devices)))
    return out


@pytest.mark.parametrize("line", HLO_LINES,
                         ids=[ln.split()[0].lstrip("%") for ln in HLO_LINES])
@pytest.mark.parametrize("n_devices", [1, 8])
def test_collective_wire_equals_parse_collectives_per_line(line, n_devices):
    assert RL.collective_wire(_as_records([line], n_devices), n_devices) == \
        REF.parse_collectives(line, n_devices)


def test_collective_wire_equals_parse_collectives_over_a_program():
    hlo = "\n".join(["HloModule m", "ENTRY %main {", *HLO_LINES,
                     "%add = f32[4]{0} add(f32[4]{0} %a, f32[4]{0} %b)",
                     "}"])
    want = REF.parse_collectives(hlo, 8)
    assert RL.collective_wire(_as_records(HLO_LINES, 8), 8) == want
    assert want["counts"]["all-reduce"] == 5


def test_collective_wire_takes_communicator_kinds():
    """The Communicator's spelling, and None for the whole mesh."""
    got = RL.collective_wire([("all_reduce", 1024, None),
                              ("all_gather", 4096, 4),
                              ("all_to_all", 512, None)], 4)
    assert got["all-reduce"] == 2.0 * 1024 * 3 / 4
    assert got["all-gather"] == 4096 * 3 / 4
    assert got["all-to-all"] == 512 * 3 / 4
    assert got["counts"] == {"all-gather": 1, "all-reduce": 1,
                             "reduce-scatter": 0, "all-to-all": 1,
                             "collective-permute": 0}
    with pytest.raises(ValueError, match="unknown collective"):
        RL.collective_wire([("broadcast", 8, 2)], 2)
