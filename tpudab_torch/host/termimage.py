"""Terminal slideshow rendering: kitty graphics / sixel / ANSI half-block.

Counterpart of tpudab.host.termimage (a copy). Reference parity: the
plugin renders decoded MOT slideshow images to screen through stb_image +
an OpenGL texture cache (the reference's src/render_radio_block.cpp:309-384,
src/texture.cpp:15-17). There is no GUI stack by design; the equivalent
surface is the terminal itself:

- kitty graphics protocol (TERM=xterm-kitty and friends): the original
  PNG/JPEG bytes are transmitted base64-chunked — full-fidelity inline.
- sixel (TERM with 'sixel', mlterm, etc.): 216-color 6x6x6 cube encoding.
- ANSI half-block fallback (any truecolor terminal): two pixels per cell
  via U+2580 with 24-bit fg/bg.

Selection: TPUDAB_TERMIMG=kitty|sixel|half|off overrides auto-detection.
Decode uses PIL (PNG/JPEG — the exact formats the reference's stb loader
accepts, texture.cpp:15-17).
"""

from __future__ import annotations

import base64
import io
import os
from typing import Optional

import numpy as np

ESC = "\x1b"


def decode_image(data: bytes) -> Optional[np.ndarray]:
    """PNG/JPEG bytes -> (H, W, 3) uint8 RGB, or None if undecodable."""
    try:
        from PIL import Image
    except ImportError:                                     # pragma: no cover
        return None
    try:
        img = Image.open(io.BytesIO(data))
        return np.asarray(img.convert("RGB"), dtype=np.uint8)
    except Exception:
        return None


def _fit(rgb: np.ndarray, max_cols: int, max_rows: int) -> np.ndarray:
    """Area-downsample to fit a cols x rows cell budget (2 px per cell row
    for the half-block form). Never upscales."""
    h, w, _ = rgb.shape
    scale = min(max_cols / w, (2 * max_rows) / h, 1.0)
    nw, nh = max(int(w * scale), 1), max(int(h * scale), 1)
    ys = (np.arange(nh) * h // nh).clip(0, h - 1)
    xs = (np.arange(nw) * w // nw).clip(0, w - 1)
    return rgb[ys][:, xs]


def render_halfblock(rgb: np.ndarray, max_cols: int = 60,
                     max_rows: int = 18) -> str:
    """Two vertically-stacked pixels per character cell: U+2580 with the
    top pixel as 24-bit foreground and the bottom as background."""
    img = _fit(rgb, max_cols, max_rows)
    h, w, _ = img.shape
    if h % 2:
        img = np.concatenate([img, np.zeros((1, w, 3), np.uint8)])
        h += 1
    top, bot = img[0::2], img[1::2]
    lines = []
    for r in range(h // 2):
        cells = []
        for c in range(w):
            tr, tg, tb = (int(x) for x in top[r, c])
            br, bg_, bb = (int(x) for x in bot[r, c])
            cells.append(f"{ESC}[38;2;{tr};{tg};{tb}m"
                         f"{ESC}[48;2;{br};{bg_};{bb}m▀")
        lines.append("".join(cells) + f"{ESC}[0m")
    return "\n".join(lines)


def render_kitty(data: bytes, image_format: str = "png",
                 max_cols: int = 60, max_rows: int = 18) -> str:
    """kitty graphics protocol: transmit the ORIGINAL compressed bytes
    (f=100 = PNG; JPEG is re-encoded to PNG first), display inline scaled
    to a cell budget (c=/r= let kitty do the scaling)."""
    if image_format.lower() not in ("png",):
        rgb = decode_image(data)
        if rgb is None:
            return ""
        from PIL import Image
        buf = io.BytesIO()
        Image.fromarray(rgb).save(buf, format="PNG")
        data = buf.getvalue()
    payload = base64.standard_b64encode(data).decode("ascii")
    chunks = [payload[i : i + 4096] for i in range(0, len(payload), 4096)]
    out = []
    for i, chunk in enumerate(chunks):
        ctrl = []
        if i == 0:
            ctrl.append(f"a=T,f=100,c={max_cols},r={max_rows}")
        ctrl.append(f"m={1 if i + 1 < len(chunks) else 0}")
        out.append(f"{ESC}_G{','.join(ctrl)};{chunk}{ESC}\\")
    return "".join(out)


def render_sixel(rgb: np.ndarray, max_cols: int = 60,
                 max_rows: int = 18) -> str:
    """Sixel with a fixed 6x6x6 color cube (216 registers). Assumes ~10 px
    per text column / ~20 px per row for the cell budget."""
    img = _fit(rgb, max_cols * 10, max_rows * 10)
    h, w, _ = img.shape
    q = (img.astype(np.int32) * 6 // 256).clip(0, 5)        # (H, W, 3) 0..5
    idx = q[..., 0] * 36 + q[..., 1] * 6 + q[..., 2]        # (H, W) 0..215
    out = [f"{ESC}Pq"]
    levels = [0, 20, 40, 60, 80, 100]
    for n in range(216):
        r, g, b = n // 36, (n // 6) % 6, n % 6
        out.append(f"#{n};2;{levels[r]};{levels[g]};{levels[b]}")
    pad = (-h) % 6
    if pad:
        idx = np.concatenate([idx, np.full((pad, w), -1, idx.dtype)])
    for band in idx.reshape(-1, 6, w):
        used = np.unique(band)
        first = True
        for color in used[used >= 0]:
            mask = band == color                            # (6, W)
            bits = (mask * (1 << np.arange(6))[:, None]).sum(axis=0)
            if not first:
                out.append("$")
            first = False
            out.append(f"#{color}")
            run_c, run_n = None, 0
            for v in np.concatenate([bits, [-1]]):
                if v == run_c:
                    run_n += 1
                    continue
                if run_c is not None:
                    ch = chr(63 + int(run_c))
                    out.append(f"!{run_n}{ch}" if run_n > 3 else ch * run_n)
                run_c, run_n = v, 1
        out.append("-")
    out.append(f"{ESC}\\")
    return "".join(out)


def detect_mode() -> str:
    """'kitty' | 'sixel' | 'half' | 'off' (TPUDAB_TERMIMG overrides)."""
    force = os.environ.get("TPUDAB_TERMIMG", "").lower()
    if force in ("kitty", "sixel", "half", "off"):
        return force
    term = os.environ.get("TERM", "")
    if "kitty" in term or os.environ.get("KITTY_WINDOW_ID"):
        return "kitty"
    if "sixel" in term or "mlterm" in term:
        return "sixel"
    return "half"


def render_slide(data: bytes, image_format: str = "png",
                 mode: Optional[str] = None, max_cols: int = 60,
                 max_rows: int = 18) -> str:
    """Render compressed slide bytes for the active terminal; '' if the
    image does not decode or rendering is off."""
    mode = mode or detect_mode()
    if mode == "off":
        return ""
    if mode == "kitty":
        return render_kitty(data, image_format, max_cols, max_rows)
    rgb = decode_image(data)
    if rgb is None:
        return ""
    if mode == "sixel":
        return render_sixel(rgb, max_cols, max_rows)
    return render_halfblock(rgb, max_cols, max_rows)
