"""Shared set-up of the training parity tests (tests/test_torch_grad.py,
tests/test_torch_train.py): SMOKE configs of both packages, the
reference's SMOKE parameters and the port's copy of them, seeded numpy
batches with next-token labels, and one forward + backward of the port.
"""
import dataclasses

import jax
import numpy as np
import torch

from repro import configs as ref_configs
from repro.models import model as RM
from repro.models import moe as RMOE
from repro_torch import configs
from repro_torch.convert import params_from_numpy
from repro_torch.models import model as M
from repro_torch.optim.adamw import tree_leaves

GRANITE = "granite_moe_3b_a800m"
_REF_PARAMS = {}


def cfgs(arch, dtype):
    return (dataclasses.replace(ref_configs.get_config(arch, smoke=True),
                                dtype=dtype),
            dataclasses.replace(configs.get_config(arch, smoke=True),
                                dtype=dtype))


def ref_params(arch):
    """The reference's SMOKE parameters from ``PRNGKey(0)``, as numpy."""
    if arch not in _REF_PARAMS:
        _REF_PARAMS[arch] = jax.tree.map(np.asarray, RM.init_params(
            ref_configs.get_config(arch, smoke=True), jax.random.PRNGKey(0)))
    return _REF_PARAMS[arch]


def port_params(arch):
    """A fresh copy of the reference's parameters, every leaf a grad
    leaf."""
    p = params_from_numpy(ref_params(arch), "cpu")
    for x in tree_leaves(p):
        x.requires_grad_(True)
    return p


def batch_for(cfg, B, S, seed):
    """Inputs and next-token labels for ``cfg``'s input mode, as numpy."""
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "embeddings":
        return {"embeddings": rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32),
            "labels": rng.integers(0, cfg.vocab_size, (B, S))
            .astype(np.int32)}
    extra = () if cfg.input_mode == "tokens" else (cfg.n_codebooks,)
    t = rng.integers(0, cfg.vocab_size, (B, S + 1) + extra).astype(np.int32)
    return {"tokens": t[:, :-1], "labels": t[:, 1:]}


def influence(cfg):
    rs = RMOE.init_router_state(cfg)
    return None if rs is None else np.asarray(rs["influence"])


def port_loss_and_grad(arch, pcfg, batch, infl, remat=False):
    """The port's ``loss_fn(forward(...))`` on a fresh copy of the
    reference's parameters, and its backward. Returns (loss, logits, the
    gradients in sorted-key leaf order, zeros where the loss does not
    reach a leaf)."""
    params = port_params(arch)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    logits, _, _ = M.forward(params, tb, pcfg, remat=remat,
                             influence=None if infl is None
                             else torch.from_numpy(infl))
    loss = M.loss_fn(logits, tb["labels"], pcfg)
    loss.backward()
    grads = [torch.zeros_like(p) if p.grad is None else p.grad
             for p in tree_leaves(params)]
    return loss, logits, grads
