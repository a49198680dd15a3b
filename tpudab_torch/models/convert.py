"""State carried across from tpudab to the port, mid-stream.

- The ReceiveStep carry: tpudab's is a dict of jax arrays; np.asarray
  turns it into numpy arrays of float32 or of ml_dtypes' bfloat16. Those
  bf16 arrays are read here through a 16-bit integer view, so nothing of
  ml_dtypes is imported.
- A host per-stage SubchannelDecoder: its deinterleave history, CIF count,
  geometry and UEP calibration state.
- A checkpoint's carry (models/checkpoint.py): the port's, f32 or bf16
  stored as its int16 view, or tpudab's, whose .npz holds f32 arrays and
  whose JSON names no carry_dtype.

Only attributes are read, and nothing of jax is imported.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

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


def carry_from_npz(arrays: Dict[str, np.ndarray], carry_dtype: Optional[str],
                   device) -> Dict[str, torch.Tensor]:
    """A checkpoint's arrays -> torch tensors on device, bit for bit:
    carry_dtype "bfloat16" reads int16 views as bf16; "float32", or None
    (a tpudab checkpoint, whose carry is f32), reads float32 arrays. None
    also stands for a checkpoint whose JSON is gone: its int16 arrays can
    only be the port's bf16 views."""
    out = {}
    for k, v in arrays.items():
        v = np.asarray(v)
        if carry_dtype in (None, "bfloat16") and v.dtype == np.int16:
            t = torch.from_numpy(v.copy()).view(torch.bfloat16)
        elif carry_dtype in (None, "float32") and v.dtype == np.float32:
            t = torch.from_numpy(v.copy())
        else:
            raise TypeError(f"checkpoint carry {k!r} is {v.dtype}, which does not "
                            f"hold a {carry_dtype or 'float32'} carry")
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


def subchannel_state_from_jax(dec, device):
    """A tpudab.msc.subchannel.SubchannelDecoder -> a port SubchannelDecoder
    on device that continues the same stream: the same config (after any
    calibration swap), the f32 history, the CIF count, the calibration
    result and the frames a pending calibration holds."""
    from tpudab_torch.fec.uep_calibrate import CalibrationResult
    from tpudab_torch.msc.subchannel import SubchannelConfig, SubchannelDecoder

    c = dec.config
    cfg = SubchannelConfig(c.subch_id, c.start_cu, c.size_cu, c.profile,
                           c.padding_bits, c.uep_key)
    out = SubchannelDecoder(cfg, device)
    out._history = torch.from_numpy(np.array(dec._history, dtype=np.float32)).to(out.device)
    out._n_seen = int(dec._n_seen)
    cal = dec.calibration
    out.calibration = None if cal is None else CalibrationResult(
        **{f.name: getattr(cal, f.name) for f in dataclasses.fields(cal)})
    out._cal_pending = bool(dec._cal_pending)
    out._cal_buf = [torch.from_numpy(np.array(b, dtype=np.float32)).to(out.device)
                    for b in dec._cal_buf]
    return out
