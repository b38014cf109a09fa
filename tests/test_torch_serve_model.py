"""Serving over the ``model`` axis on a ``(1, 2)`` mesh: the port's
prefill, decode steps and ``ServeEngine`` on two thread ranks (attention
by heads, the dense MLP by ``mlp``, MoE by experts, the vocabulary and
codebook heads by ``vocab``) against the reference's on
``make_host_mesh(1, 2)``, for granite (MoE, 6:2 heads as 3:1 a rank),
gemma3 (MQA: its one KV head whole on each rank; sliding window; also
with the ring cache), starcoder2 (9 heads held whole, the GELU MLP
split), phi3 (MHA), llama4 (experts split, 5 heads whole, the shared
expert), musicgen (codebooks) and internvl2 (embedding inputs, through
``make_serve_step``), float32, and granite and gemma3 in bfloat16 too.
Also: the routing bit-equal across the model ranks, the embedding
bit-equal to one rank's and the shard shapes the reference's.
Set-up and tolerances: tests/serve_model_cases.py; the ``(2, 2)`` mesh:
tests/test_torch_serve_model_data.py; jamba and rwkv6:
tests/test_torch_serve_model_ssm.py.
"""
import pytest
import torch

import serve_model_cases as C

torch.set_num_threads(1)

MESH = (1, 2)
SERVED = [c for c in C.CASES if c[0] != "internvl2_76b"]


@pytest.mark.parametrize("case", C.CASES, ids=C.case_id)
def test_prefill_matches_reference(case):
    """The last position's logits of each rank's rows and each rank's
    cache (its rows, its KV heads) against the reference's."""
    C.check_prefill(case, MESH)


@pytest.mark.parametrize("case", C.CASES, ids=C.case_id)
def test_decode_steps_match_reference(case):
    """``STEPS`` one-token steps of ``make_serve_step`` from an empty
    cache: the whole logits on every rank a step, the greedy tokens in
    float32, each rank's final cache."""
    C.check_decode(case, MESH)


@pytest.mark.parametrize("case", SERVED, ids=C.case_id)
def test_engine_transcripts_match_reference(case):
    """``ServeEngine.run`` of four padded requests: the same transcripts
    on every rank, the reference's (bfloat16: up to a near-tie)."""
    C.check_engine(case, MESH)


@pytest.mark.parametrize("case", [c for c in C.CASES if c[0] in C.MOE],
                         ids=C.case_id)
def test_routing_is_bit_equal_across_model_ranks(case):
    C.check_routing(case, MESH)


@pytest.mark.parametrize("case", C.CASES, ids=C.case_id)
def test_embedding_and_shard_shapes(case):
    C.check_embedding_and_shapes(case, MESH)
