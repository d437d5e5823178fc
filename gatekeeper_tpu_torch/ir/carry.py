"""Host eval inputs -> tensors on one device.

The evaluator's inputs are nested dicts of numpy arrays: features and
encoded parameters ({slot: {name: array}}), derived columns ({col:
{name: array}}) and the bit-packed match table ([V, W] uint32). Torch
has no usable uint32 on the CPU (shifts, compares and nonzero raise), so
uint32 leaves cross as their int32 view: the same bits, and every
kernel tests them with shifts and masks, never with a signed compare.
"""

from __future__ import annotations

import numpy as np
import torch


def to_tensor(arr, device) -> torch.Tensor:
    """One host array -> a tensor on `device` (uint32 as its int32 view)."""
    a = np.asarray(arr)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def tree_from_numpy(tree, device):
    """Map to_tensor over a nested dict (or a single array)."""
    if isinstance(tree, dict):
        return {k: tree_from_numpy(v, device) for k, v in tree.items()}
    return to_tensor(tree, device)
