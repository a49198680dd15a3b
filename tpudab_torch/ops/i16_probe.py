"""The int16 op probe: 13 elementwise int16 ops, one per launch.

Counterpart of tools/exp_i16_probe.py::probe (X4), which asked whether the
TPU's kernel compiler lowers each int16 op that the int16 Viterbi
(tools/exp_viterbi_i16.py) needs; run by tpudab_torch/tools/exp_i16_probe.py.
i16_probe(x, y, op) takes two (R, C) int16 tensors and returns the op's
(R, C) int16 result with JAX's semantics: int16 arithmetic wraps, and
shift_right_logical shifts the 16-bit pattern in zeros, which torch has no
op for on a signed type, so the plain twin masks to 16 bits in int32. A
CPU tensor takes the twin, a CUDA tensor the kernel in csrc/i16_probe.cu.
"""

from __future__ import annotations

import torch

from tpudab_torch.ops import _build


def _srl15(v: torch.Tensor) -> torch.Tensor:
    return ((v.to(torch.int32) & 0xFFFF) >> 15).to(torch.int16)


def _repeat(x, y):
    return torch.repeat_interleave(x[0: x.shape[0] // 4], 4, dim=0)


# name -> plain torch body, in the order of tools/exp_i16_probe.py:22-34 and
# of csrc/i16_probe.cu's op ids
OPS = {
    "add": lambda x, y: x + y,
    "max": torch.maximum,
    "mul": lambda x, y: x * y,
    "shift_right_logical": lambda x, y: _srl15(x),
    "shift_right_arith": lambda x, y: x >> 15,
    "and/or": lambda x, y: (x & y) | x,
    "compare_gt": lambda x, y: (x > y).to(torch.int16),
    "select_by_signshift": lambda x, y: torch.where(_srl15(x - y) > 0, x, y),
    "sub": lambda x, y: x - y,
    "repeat": _repeat,
    "i16_to_u8": lambda x, y: (x & 3).to(torch.uint8).to(torch.int16),
    "bcast_1row": lambda x, y: x[0:1, :] + y,
    "bcast_1col_x_1row": lambda x, y: x[:, 0:1] * y[0:1, :],
}
OP_IDS = {name: i for i, name in enumerate(OPS)}


def _check(x: torch.Tensor, y: torch.Tensor, op: str) -> None:
    if op not in OPS:
        raise ValueError(f"unknown int16 op {op!r}; one of {list(OPS)}")
    if x.dtype != torch.int16 or y.dtype != torch.int16 or x.shape != y.shape \
            or x.dim() != 2 or x.shape[0] % 4:
        raise ValueError(f"the probe takes two int16 (R, C) tensors with R % 4 == 0, "
                         f"got {x.dtype} {tuple(x.shape)} and {y.dtype} {tuple(y.shape)}")


def i16_probe_ref(x: torch.Tensor, y: torch.Tensor, op: str) -> torch.Tensor:
    """Plain torch twin of the probe kernel."""
    _check(x, y, op)
    return OPS[op](x, y).to(torch.int16)


def i16_probe_cuda(x: torch.Tensor, y: torch.Tensor, op: str) -> torch.Tensor:
    """The probe kernel on contiguous CUDA tensors."""
    _check(x, y, op)
    if not (x.is_cuda and y.is_cuda and x.is_contiguous() and y.is_contiguous()):
        raise ValueError("i16_probe_cuda takes contiguous CUDA tensors")
    if x.get_device() != y.get_device():
        raise ValueError(f"x and y lie on different cards: {x.device}, {y.device}")
    out = torch.empty_like(x)
    rows, cols = x.shape
    _build.launch(_build.load_library().tpudab_i16_probe, x.get_device(), f"int16 probe {op}",
                  x.data_ptr(), y.data_ptr(), out.data_ptr(), rows, cols, OP_IDS[op])
    i16_probe_cuda.launches += 1
    return out


i16_probe_cuda.launches = 0


def i16_probe(x: torch.Tensor, y: torch.Tensor, op: str) -> torch.Tensor:
    """Dispatch on x's device: CPU -> twin, CUDA -> kernel."""
    if x.device.type == "cpu":
        return i16_probe_ref(x, y, op)
    return i16_probe_cuda(x, y, op)
