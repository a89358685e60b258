"""Per-point labels of one forward (K15, lidog_tpu/serve.py:92-105).

The argmax of the level-0 logits on real rows (first maximum), carried
through the plan's `pos` (input row -> level-0 row) and, on the sorted
path, the voxelizer's inverse map (point -> input row), with -1 wherever
the chain breaks.  `label_gather` is LD (csrc/label_gather.cu, one
launch) for CUDA tensors and `labels_plain` for CPU tensors.
"""

from __future__ import annotations

import torch

from lidog_tpu_torch.ops import _cuda
from lidog_tpu_torch.ops._wrap import DTYPES

LAUNCHES = {"label_gather": 0}


def labels_plain(logits, real, pos, inverse=None):
    """The plain version of LD: argmax of logits [N0, C] on the real rows
    (first maximum), -1 elsewhere; per input row through pos [N_in] (row
    -> level-0 row, -1 dropped); on the sorted path per point through
    inverse [P] (point -> input row, -1 dropped)."""
    vox_pred = torch.argmax(logits, dim=-1).to(torch.int32)
    vox_pred = torch.where(real, vox_pred, -1)
    pred_of_in = torch.where(pos >= 0, vox_pred[pos.clamp(min=0).long()], -1)
    if inverse is None:
        return pred_of_in
    return torch.where(inverse >= 0,
                       pred_of_in[inverse.clamp(min=0).long()], -1)


def label_gather(logits, real, pos, inverse=None):
    """LD (csrc/label_gather.cu, K15: one launch) for CUDA tensors,
    labels_plain for CPU tensors; arguments as labels_plain's."""
    if logits.device.type == "cpu":
        return labels_plain(logits, real, pos, inverse)
    name = "label_gather"
    dev = logits.device
    n_rows, c = logits.shape
    n_in = pos.shape[0]
    checks = [
        (dev.type == "cuda", f"the kernel takes CUDA tensors, got {dev}"),
        (logits.dtype in DTYPES, "logits must be float32 or bfloat16"),
        (real.dtype == torch.bool and tuple(real.shape) == (n_rows,),
         f"real must be bool [{n_rows}]"),
        (pos.dtype == torch.int32 and pos.dim() == 1, "pos must be int32 [N]"),
        (inverse is None or (inverse.dtype == torch.int32
                             and inverse.dim() == 1),
         "inverse must be int32 [P]"),
    ]
    for t in (logits, real, pos, inverse):
        if t is not None:
            checks.append((t.device == dev and t.is_contiguous(),
                           f"inputs must be contiguous on {dev}"))
    for ok, msg in checks:
        if not ok:
            raise ValueError(f"{name}: {msg}")
    n_out = n_in if inverse is None else inverse.shape[0]
    out = torch.empty(n_out, dtype=torch.int32, device=dev)
    if n_out:
        _cuda.call(name, logits.data_ptr(), real.data_ptr(), pos.data_ptr(),
                   None if inverse is None else inverse.data_ptr(),
                   out.data_ptr(), n_rows, c, n_in, n_out,
                   DTYPES[logits.dtype])
        LAUNCHES[name] += 1
    return out
