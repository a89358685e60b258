"""Carry flax variables and train states of lidog_tpu into the port.

The flax tree {'params': ..., 'batch_stats': ...} (nested dicts of numpy
arrays; call jax.device_get on the JAX side) maps leaf by leaf onto the
port's state_dict: the path `backbone/block2_0/conv1/kernel` becomes the
key `backbone.block2_0.conv1.kernel`, with the same shape and dtype.
batch_stats leaves (BatchNorm `mean`/`var`) become buffers, the rest
parameters: the two collections share no leaf name.  This holds for
MinkUNet34BEV's Encoder2D subtrees too (`encoder2d_block8.down1.conv0.
kernel` [3, 3, Cin, Cout], flax BatchNorm `bn0.scale`/`bias`/`mean`/
`var`).  MinkUNet34Robust's and MinkUNet34IBN's trees have no `backbone`
level (`block1_0.norm1.bn.scale`), and their instance norms hold no
leaves, as the port's modules hold no parameters or buffers.

A lidog_tpu TrainState (params, batch_stats, the optax Adam state, step;
also through jax.device_get) carries into the port's TrainState, so that
the port continues the same run.  Imports no JAX.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

COLLECTIONS = ("params", "batch_stats")


def _flatten(tree, prefix, out):
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict) or hasattr(v, "items"):
            _flatten(v, key, out)
        else:
            if key in out:
                raise ValueError(f"two flax leaves map to {key!r}")
            out[key] = torch.from_numpy(np.array(v))
    return out


def state_dict_from_flax(variables) -> Dict[str, torch.Tensor]:
    """{'params', 'batch_stats'} numpy tree -> torch state_dict."""
    out: Dict[str, torch.Tensor] = {}
    for col in COLLECTIONS:
        if col in variables:
            _flatten(variables[col], "", out)
    return out



def load_train_state(state, jax_state) -> None:
    """Load a numpy lidog_tpu TrainState with an Adam optax state into the
    port's TrainState (lidog_tpu_torch.train.train_step), in place: params
    and batch_stats into the model; Adam's mu, nu and count as torch's
    exp_avg, exp_avg_sq and step; step into both step counts."""
    model = state.model
    model.load_state_dict(state_dict_from_flax(
        {"params": jax_state.params, "batch_stats": jax_state.batch_stats}),
        strict=True)
    named = dict(model.named_parameters())
    adam = [p for p in jax_state.opt_state if hasattr(p, "mu")]
    if len(adam) != 1:
        raise ValueError("expected one Adam state in the optax chain, found "
                         f"{len(adam)}")
    mu, nu = _flatten(adam[0].mu, "", {}), _flatten(adam[0].nu, "", {})
    if set(mu) != set(named) or set(nu) != set(named):
        raise ValueError("the Adam state does not match the model's "
                         "parameters")
    for name, p in named.items():
        state.optimizer.opt.state[p] = {
            "step": torch.tensor(float(adam[0].count)),
            "exp_avg": mu[name].to(p.device),
            "exp_avg_sq": nu[name].to(p.device)}
    state.step = state.optimizer.count = int(jax_state.step)
