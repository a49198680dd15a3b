"""The demod's tail after the bf16 Karatsuba DFT products, in three kernels.

The products m1, m2, m3 ((F, n_sym, K) bf16, ofdm/demod.py) become the
spectra cr = m1 - m2 and ci = m3 + m1, the DQPSK demap z_l * conj(z_{l-1})
gives dr and di ((F, n_sym - 1, K)), and the soft bits are [dr | di] per
symbol divided by the frame's mean magnitude. demap (pass 1) sums |dr| and
|di| per frame chunk; norm (pass 2) forms dr and di again and writes them
normalised; stats gives each frame's mean_power and the last frame's
unit-RMS constellation tap. On CUDA tensors each is one launch of
csrc/demod_tail.cu; on the CPU each takes its plain twin (*_ref), which
repeats the kernel's rounding points and summation order, so the two agree
bit for bit. The twins round as the eager bf16 chain of ofdm/demod.py does
(dr and di bit-equal to it); only the order of the f32 sums behind the
frame's mean, mean_power and the tap's scale differs from the chain's.
stats also takes rtl_sdr's raw u8 frames (frames_im None, as
ops/carve.py takes them): its twin converts them with u8_parts, the
kernel in registers, exactly in both.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpudab_torch.ops import _build
from tpudab_torch.ops.carve import IN_DTYPE, u8_flat, u8_frames_at, u8_parts

ROWS = 19             # demapped rows a block of either pass walks
STATS_THREADS = 256   # stats_kernel's block
LANES = 8             # carriers (samples) a thread owns
N_TAP = 480           # the constellation tap's points (ofdm/demod.py N_CONST_POINTS)
TAP_PAD = 512


def tap_geometry(n_sym: int, k: int):
    """(stride, points) of the tap: every stride-th element of the last
    frame's flattened (n_sym - 1, K) dr and di, at most N_TAP of them."""
    n = (n_sym - 1) * k
    stride = max(1, n // N_TAP)
    return stride, min(N_TAP, -(-n // stride))


def _chunks(n_sym: int) -> int:
    return -(-(n_sym - 1) // ROWS)


# ---------------- plain twins ----------------

def _bf(x: torch.Tensor) -> torch.Tensor:
    """One torch bf16 op's rounding of an f32 result, kept in f32."""
    return x.to(torch.bfloat16).float()


def spectra_ref(m1, m2, m3):
    """bf16 products -> the spectra (cr, ci) = (bf16(m1 - m2), bf16(m3 + m1)), in f32."""
    a, b, c = m1.float(), m2.float(), m3.float()
    return _bf(a - b), _bf(c + a)


def demap_parts_ref(cr, ci):
    """(F, n_sym, K) spectra -> (dr, di) (F, n_sym - 1, K) in f32, each
    product, sum and difference rounded to bf16."""
    cr1, cr0, ci1, ci0 = cr[:, 1:], cr[:, :-1], ci[:, 1:], ci[:, :-1]
    dr = _bf(_bf(cr1 * cr0) + _bf(ci1 * ci0))
    di = _bf(_bf(ci1 * cr0) - _bf(cr1 * ci0))
    return dr, di


def _lanes(a: torch.Tensor) -> torch.Tensor:
    """(..., 8) -> ((a0 + a1) + (a2 + a3)) + ((a4 + a5) + (a6 + a7))."""
    return (((a[..., 0] + a[..., 1]) + (a[..., 2] + a[..., 3]))
            + ((a[..., 4] + a[..., 5]) + (a[..., 6] + a[..., 7])))


def _tree(s: torch.Tensor) -> torch.Tensor:
    """(..., n) -> (...): the block's sum, n padded with zeros to a power
    of two p, then s[:h] + s[h:2h] for h = p/2 .. 1."""
    p = 1 << (s.shape[-1] - 1).bit_length()
    s = F.pad(s, (0, p - s.shape[-1]))
    while p > 1:
        p //= 2
        s = s[..., :p] + s[..., p:2 * p]
    return s[..., 0]


def _div(a: torch.Tensor, n: int) -> torch.Tensor:
    """a / n, divided as a tensor (a Python number would be multiplied by
    its reciprocal on CUDA)."""
    return a / torch.full_like(a, float(n))


def demap_ref(m1, m2, m3):
    """Twin of demap_kernel: (F, n_sym, K) bf16 products -> (F, chunks, 2)
    f32 partials, sum |dr| and sum |di| over chunk c's rows (rows c*ROWS ..
    of the demapped n_sym - 1), as each thread sums its 8 carriers' rows in
    order, then lanes and threads in the kernel's trees."""
    dr, di = demap_parts_ref(*spectra_ref(m1, m2, m3))
    f, n, k = dr.shape
    c = _chunks(n + 1)
    out = []
    for x in (dr, di):
        x = F.pad(x.abs(), (0, 0, 0, c * ROWS - n)).view(f, c, ROWS, k // LANES, LANES)
        acc = torch.zeros_like(x[:, :, 0])
        for j in range(ROWS):
            acc = acc + x[:, :, j]
        out.append(_tree(_lanes(acc)))
    return torch.stack(out, dim=-1)


def _denom(partials: torch.Tensor, n: int) -> torch.Tensor:
    """(F, chunks, 2) partials -> (F,) max(0.5 (sum|dr| / n + sum|di| / n), 1e-20)."""
    sr, si = partials[:, 0, 0], partials[:, 0, 1]
    for c in range(1, partials.shape[1]):
        sr, si = sr + partials[:, c, 0], si + partials[:, c, 1]
    mean = 0.5 * (_div(sr, n) + _div(si, n))
    return torch.where(mean < 1e-20, torch.full_like(mean, 1e-20), mean)


def norm_ref(m1, m2, m3, partials, out_dtype=torch.bfloat16):
    """Twin of norm_kernel: -> (F, (n_sym - 1) * 2K) soft bits in out_dtype,
    row l of a frame being [dr_l | di_l] / denom."""
    dr, di = demap_parts_ref(*spectra_ref(m1, m2, m3))
    f, n, k = dr.shape
    denom = _denom(partials, n * k)[:, None, None]
    soft = torch.cat([(dr / denom).to(out_dtype), (di / denom).to(out_dtype)], dim=-1)
    return soft.reshape(f, -1)


def stats_ref(frames_re, frames_im, m1, m2, m3, starts=None, frame_len=None):
    """Twin of stats_kernel: frames (F, ...) bf16 or f32, any tiling, or u8
    frames with frames_im None (or a u8 buffer of pairs with starts, each
    frame's first pair, and frame_len), and the products -> (mean_power
    (F,) f32, tap (2, points) f32)."""
    f = m1.shape[0]
    if starts is not None:
        frames_re = u8_frames_at(frames_re, starts, frame_len)
    if frames_re.dtype == torch.uint8:
        frames_re, frames_im = u8_parts(frames_re, frames_re[0].numel() // 2, frames_im)
    fr = frames_re.reshape(f, -1).float()
    fi = frames_im.reshape(f, -1).float()
    n = fr.shape[1]
    step = STATS_THREADS * LANES
    j = -(-n // step)
    sq = F.pad(fr * fr + fi * fi, (0, j * step - n)).view(f, j, STATS_THREADS, LANES)
    acc = torch.zeros_like(sq[:, 0])
    for i in range(j):
        acc = acc + sq[:, i]
    mean_power = _div(_tree(_lanes(acc)), n)

    n_sym, k = m1.shape[1:]
    stride, n_tap = tap_geometry(n_sym, k)
    dr, di = demap_parts_ref(*spectra_ref(m1[-1:], m2[-1:], m3[-1:]))
    pts = torch.stack([dr.reshape(-1)[::stride][:n_tap], di.reshape(-1)[::stride][:n_tap]])
    s = _tree(F.pad(pts[0] * pts[0] + pts[1] * pts[1], (0, TAP_PAD - n_tap)))
    x = _div(s, n_tap) + 1e-20
    scale = torch.ones_like(x) / torch.sqrt(x)
    return mean_power, pts * scale


# ---------------- the kernels ----------------

def _products(m1, m2, m3):
    ms = (m1, m2, m3)
    if not all(m.is_cuda and m.dtype == torch.bfloat16 and m.is_contiguous()
               and m.data_ptr() % 16 == 0 for m in ms) \
            or m1.dim() != 3 or any(m.shape != m1.shape for m in ms) \
            or m1.shape[2] % LANES or m1.shape[2] // LANES > 1024 or m1.shape[1] < 2:
        raise ValueError(f"the demod tail takes three contiguous, 16-byte aligned CUDA bf16 "
                         f"(F, n_sym >= 2, K) products, K a multiple of 8 up to 8192; got "
                         f"{[(tuple(m.shape), m.dtype, str(m.device)) for m in ms]}")
    return m1.shape


def demap_cuda(m1, m2, m3):
    """Pass 1 (demap_kernel) on CUDA; same contract as demap_ref."""
    f, n_sym, k = _products(m1, m2, m3)
    partials = torch.empty((f, _chunks(n_sym), 2), dtype=torch.float32, device=m1.device)
    _build.launch(_build.load_library().tpudab_demod_demap, m1.get_device(), "demod_demap",
                  m1.data_ptr(), m2.data_ptr(), m3.data_ptr(), partials.data_ptr(),
                  f, n_sym, k, ROWS)
    demap_cuda.launches += 1
    return partials


def norm_cuda(m1, m2, m3, partials, out_dtype=torch.bfloat16):
    """Pass 2 (norm_kernel) on CUDA; same contract as norm_ref."""
    f, n_sym, k = _products(m1, m2, m3)
    if out_dtype not in (torch.bfloat16, torch.float32) or partials.dtype != torch.float32 \
            or not partials.is_contiguous() or partials.device != m1.device \
            or partials.dim() != 3 or partials.shape[0] != f or partials.shape[2] != 2:
        raise ValueError(f"norm_cuda takes (F, chunks, 2) f32 partials on the products' "
                         f"device and a bf16 or f32 out_dtype; got {tuple(partials.shape)} "
                         f"{partials.dtype} {partials.device}, {out_dtype}")
    soft = torch.empty((f, (n_sym - 1) * 2 * k), dtype=out_dtype, device=m1.device)
    _build.launch(_build.load_library().tpudab_demod_norm, m1.get_device(), "demod_norm",
                  m1.data_ptr(), m2.data_ptr(), m3.data_ptr(), partials.data_ptr(),
                  soft.data_ptr(), int(out_dtype == torch.bfloat16), f, n_sym, k, ROWS,
                  partials.shape[1])
    norm_cuda.launches += 1
    return soft


def stats_cuda(frames_re, frames_im, m1, m2, m3, starts=None, frame_len=None):
    """stats_kernel on CUDA; same contract as stats_ref. The frames must be
    contiguous and 16-byte aligned, as K5 takes them; with starts, a u8
    buffer of I/Q pairs alone, frame f's first pair at starts[f] of it."""
    f, n_sym, k = _products(m1, m2, m3)
    if starts is not None:
        fr = fi = frames_re
        if frames_im is not None or fr.dtype != torch.uint8 or fr.shape[-1] != 2 \
                or starts.dtype != torch.int64 or starts.numel() != f \
                or not starts.is_contiguous() or starts.device != m1.device \
                or fr.device != m1.device or not fr.is_contiguous() or fr.data_ptr() % 16 \
                or frame_len is None or frame_len % LANES:
            raise ValueError("frames at starts are a contiguous, 16-byte aligned u8 (..., 2) "
                             "buffer alone, frame_len a multiple of 8, and one contiguous "
                             "int64 start a frame on the products' device")
    else:
        if frames_re.dtype == torch.uint8:
            frame_len = frames_re[0].numel() // 2
            fr = fi = u8_flat(frames_re, frame_len, frames_im)
        else:
            fr, fi = frames_re.reshape(f, -1), frames_im.reshape(f, -1)
            frame_len = fr.shape[1]
        if fr.device != m1.device or fr.dtype != fi.dtype or fr.shape[0] != f \
                or fr.dtype not in (torch.bfloat16, torch.float32, torch.uint8) \
                or fr.shape != fi.shape or frame_len % LANES \
                or not (fr.is_contiguous() and fi.is_contiguous()) \
                or fr.data_ptr() % 16 or fi.data_ptr() % 16:
            raise ValueError(f"stats_cuda takes contiguous, 16-byte aligned bf16 or f32 "
                             f"frames, or u8 frames alone, on the products' device, (F, n) "
                             f"with n a multiple of 8; got "
                             f"{tuple(fr.shape)} {fr.dtype} {fr.device}, {tuple(fi.shape)} "
                             f"{fi.dtype}")
    stride, n_tap = tap_geometry(n_sym, k)
    mean_power = torch.empty((f,), dtype=torch.float32, device=m1.device)
    tap = torch.empty((2, N_TAP), dtype=torch.float32, device=m1.device)
    _build.launch(_build.load_library().tpudab_demod_stats, m1.get_device(), "demod_stats",
                  fr.data_ptr(), fi.data_ptr(), IN_DTYPE[fr.dtype],
                  m1.data_ptr(), m2.data_ptr(), m3.data_ptr(), mean_power.data_ptr(),
                  tap.data_ptr(), None if starts is None else starts.data_ptr(), f, frame_len,
                  n_sym, k, stride, n_tap)
    stats_cuda.launches += 1
    return mean_power, tap[:, :n_tap]


demap_cuda.launches = 0
norm_cuda.launches = 0
stats_cuda.launches = 0


# ---------------- dispatch on the products' device ----------------

def demap(m1, m2, m3):
    """CPU -> demap_ref, CUDA -> demap_kernel."""
    return (demap_ref if m1.device.type == "cpu" else demap_cuda)(m1, m2, m3)


def norm(m1, m2, m3, partials, out_dtype=torch.bfloat16):
    """CPU -> norm_ref, CUDA -> norm_kernel."""
    return (norm_ref if m1.device.type == "cpu" else norm_cuda)(m1, m2, m3, partials, out_dtype)


def stats(frames_re, frames_im, m1, m2, m3, starts=None, frame_len=None):
    """CPU -> stats_ref, CUDA -> stats_kernel. starts, frame_len: a tracked
    stream's frames, as carve.carve_rotate takes them."""
    return (stats_ref if m1.device.type == "cpu" else stats_cuda)(
        frames_re, frames_im, m1, m2, m3, starts, frame_len)
