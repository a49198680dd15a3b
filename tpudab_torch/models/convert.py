"""Carry conversion between tpudab's ReceiveStep and the port's.

tpudab's carry is a dict of jax arrays; np.asarray turns it into numpy
arrays of float32 or of ml_dtypes' bfloat16. Those bf16 arrays are read
here through a 16-bit integer view, so nothing of ml_dtypes is imported.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _is_bf16(dtype: np.dtype) -> bool:
    return dtype.name == "bfloat16" and dtype.itemsize == 2


def carry_from_jax(carry: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """{"deint_<id>": numpy f32 or bf16 array} -> torch tensors on device,
    bit for bit."""
    out = {}
    for k, v in carry.items():
        v = np.asarray(v)
        if _is_bf16(v.dtype):
            t = torch.from_numpy(v.view(np.int16).copy()).view(torch.bfloat16)
        elif v.dtype == np.float32:
            t = torch.from_numpy(v.copy())
        else:
            raise TypeError(f"carry {k!r} has dtype {v.dtype}, not f32 or bf16")
        out[k] = t.to(device)
    return out


def carry_to_numpy(carry: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The port's carry -> numpy arrays: f32 as float32, bf16 as its raw
    uint16 bits (view them as ml_dtypes.bfloat16 to hand them to jax)."""
    out = {}
    for k, t in carry.items():
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            out[k] = t.view(torch.int16).numpy().view(np.uint16)
        elif t.dtype == torch.float32:
            out[k] = t.numpy()
        else:
            raise TypeError(f"carry {k!r} has dtype {t.dtype}, not f32 or bf16")
    return out
