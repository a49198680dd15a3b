"""Checkpoint/resume of the offline pipeline: counterpart of
tpudab.models.checkpoint.

The step's carry (deinterleaver rings), the tracked frequency, the
logical-frame counters and the subchannel geometry go to one .npz and one
JSON file with tpudab's keys and fields, so a long capture can be decoded
in separate runs with bit-exact continuation. numpy has no bf16: a
bf16 carry is stored as its int16 view, and the JSON's "carry_dtype" says
so. pipeline_restore reads the port's checkpoints and tpudab's (an f32
carry, no "carry_dtype"), and casts the carry to the step's soft_dtype.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from tpudab_torch.constants.puncture import PunctureProfile
from tpudab_torch.models.convert import carry_from_npz
from tpudab_torch.msc.subchannel import SubchannelConfig
from tpudab_torch.utils.device import DEFAULT_DEVICE, resolve_device

_DTYPE_NAMES = {torch.bfloat16: "bfloat16", torch.float32: "float32"}


def _base(path: str) -> str:
    return path[:-4] if path.endswith(".npz") else path


def save_carry(path: str, carry: Dict[str, torch.Tensor],
               extra: Optional[dict] = None) -> None:
    """carry -> PATH.npz (bf16 as int16 views); extra, with "carry_dtype"
    added when the carry is not empty, -> PATH.json."""
    dtypes = {t.dtype for t in carry.values()}
    if len(dtypes) > 1 or not dtypes <= set(_DTYPE_NAMES):
        raise TypeError(f"carry dtypes {dtypes}: want one of {set(_DTYPE_NAMES)}")
    arrays = {k: (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).cpu().numpy()
              for k, t in carry.items()}
    np.savez_compressed(_base(path) + ".npz", **arrays)
    if dtypes:
        extra = dict(extra or {}, carry_dtype=_DTYPE_NAMES[dtypes.pop()])
    if extra is not None:
        with open(_base(path) + ".json", "w") as f:
            json.dump(extra, f)


def load_carry(path: str, device=DEFAULT_DEVICE):
    """(carry tensors on device, extra dict or None) from save_carry's or
    tpudab's files. The card by default; no card is an error."""
    device = resolve_device(device)
    extra = None
    jpath = _base(path) + ".json"
    if os.path.exists(jpath):
        with open(jpath) as f:
            extra = json.load(f)
    with np.load(_base(path) + ".npz") as data:
        arrays = {k: data[k] for k in data.files}
    return carry_from_npz(arrays, (extra or {}).get("carry_dtype"), device), extra


def _config_to_json(cfg) -> dict:
    return {"subch_id": cfg.subch_id, "start_cu": cfg.start_cu,
            "size_cu": cfg.size_cu, "runs": [list(r) for r in cfg.profile.runs],
            "padding_bits": cfg.padding_bits}


def _config_from_json(d) -> SubchannelConfig:
    return SubchannelConfig(
        subch_id=int(d["subch_id"]), start_cu=int(d["start_cu"]),
        size_cu=int(d["size_cu"]),
        profile=PunctureProfile(runs=tuple((int(a), int(b)) for a, b in d["runs"])),
        padding_bits=int(d["padding_bits"]))


def pipeline_checkpoint(pipeline, path: str) -> None:
    """Save an OfflinePipeline's resumable state (device-step mode):
    deinterleaver carry, tracked frequency, logical-frame counters, stream
    position and the discovered subchannel geometry, enough for a fresh
    process to continue decoding iq[next_pos:] bit-exactly with no 15-frame
    warm-up loss (CLI: decode --checkpoint / --resume)."""
    driver = pipeline._driver
    extra = {
        "net_freq_hz": pipeline.stats.net_freq_hz,
        "total_frames": pipeline.stats.total_frames,
        "next_pos": pipeline.stats.next_pos,
        "first_logical": dict(driver.first_logical),
        "subchannels": [_config_to_json(c) for c in
                        (driver.step.subchannels if driver.step is not None else ())],
    }
    save_carry(path, driver.carry or {}, extra)


def pipeline_restore(pipeline, path: str) -> None:
    """Restore state saved by pipeline_checkpoint (the port's or tpudab's)
    into a fresh pipeline. Rebuilds the ReceiveStep from the stored
    subchannel geometry, so the first batch after resume already runs the
    step with the restored carry, cast to the step's soft_dtype (the FIC
    database itself re-fills from the broadcast within a frame)."""
    driver = pipeline._driver
    carry, extra = load_carry(path, pipeline.device)
    if carry:
        driver.carry = carry
    if extra:
        pipeline.stats.net_freq_hz = extra.get("net_freq_hz", 0.0)
        driver.first_logical = {int(k): v for k, v in extra.get("first_logical", {}).items()}
        configs = tuple(_config_from_json(d) for d in extra.get("subchannels", ()))
        if configs:
            driver.step = driver.new_step(configs)
            if carry:
                driver.carry = {k: v.to(driver.step.soft_dtype) for k, v in carry.items()}
        # without the JSON the next run acquires, as a fresh one does
        pipeline._resumed = True
