"""Sharded evaluation (counterpart of ``repro/eval``): the paper's graph
metrics computed over the ranks of a mesh, equal to the host metrics::

    from repro_torch.eval import ShardedGraph, evaluate_sharded

    prob = PartitionProblem.from_mesh(mesh, k=64)
    res = partition(prob, devices=4)
    evaluate_sharded(prob, res.labels, devices=4)   # == res.evaluate()

The paper's §5 comparison matrix, every method over the mesh zoo with
its refined sibling rows, evaluated and refined over the ranks::

    from repro_torch.eval.experiments import run_matrix   # §5 tables
"""
from .sharded import (ShardedGraph, boundary_nodes_sharded,
                      comm_volume_sharded, edge_cut_sharded,
                      evaluate_sharded)

__all__ = [
    "ShardedGraph", "edge_cut_sharded", "comm_volume_sharded",
    "boundary_nodes_sharded", "evaluate_sharded",
]
