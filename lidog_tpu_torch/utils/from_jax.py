"""Carry flax variables of lidog_tpu's MinkUNet34 into the port.

The flax tree {'params': ..., 'batch_stats': ...} (nested dicts of numpy
arrays; call jax.device_get on the JAX side) maps leaf by leaf onto the
port's state_dict: the path `backbone/block2_0/conv1/kernel` becomes the
key `backbone.block2_0.conv1.kernel`, with the same shape and dtype.
batch_stats leaves (BatchNorm `mean`/`var`) become buffers, the rest
parameters: the two collections share no leaf name.  Imports no JAX.
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

