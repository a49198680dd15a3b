"""Slideshow image validation: PNG/JPEG (+GIF/BMP) header + dimension parse.

Counterpart of tpudab.mot.imagemeta. A slide that is not a valid PNG/JPEG
is rejected; validation is a structural header/dimension parse (pure
Python struct checks, no image library): a truncated or corrupt slide body
is flagged instead of silently "decoded".
"""

from __future__ import annotations

import dataclasses
import struct
import zlib
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ImageInfo:
    format: str          # "PNG" | "JPEG" | "GIF" | "BMP"
    width: int
    height: int


_PNG_SIG = b"\x89PNG\r\n\x1a\n"

# a tiny valid 4x4 red PNG (demo slideshow + test fixture)
TINY_PNG = bytes.fromhex(
    "89504e470d0a1a0a0000000d494844520000000400000004080200000026"
    "9309290000001449444154789c633c2127c700034c0c4800370700347601"
    "0caf6ab9b50000000049454e44ae426082")
# a tiny valid 4x4 red JPEG (test fixture)
TINY_JPEG = bytes.fromhex(
    "ffd8ffe000104a46494600010100000100010000ffdb004300100b0c0e0c"
    "0a100e0d0e1211101318281a181616183123251d283a333d3c3933383740"
    "485c4e404457453738506d51575f626768673e4d71797064785c656763ff"
    "db0043011112121815182f1a1a2f63423842636363636363636363636363"
    "636363636363636363636363636363636363636363636363636363636363"
    "6363636363636363ffc00011080004000403012200021101031101ffc400"
    "1f0000010501010101010100000000000000000102030405060708090a0b"
    "ffc400b5100002010303020403050504040000017d010203000411051221"
    "31410613516107227114328191a1082342b1c11552d1f02433627282090a"
    "161718191a25262728292a3435363738393a434445464748494a53545556"
    "5758595a636465666768696a737475767778797a838485868788898a9293"
    "9495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6"
    "c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7"
    "f8f9faffc4001f0100030101010101010101010000000000000102030405"
    "060708090a0bffc400b51100020102040403040705040400010277000102"
    "031104052131061241510761711322328108144291a1b1c109233352f015"
    "6272d10a162434e125f11718191a262728292a35363738393a4344454647"
    "48494a535455565758595a636465666768696a737475767778797a828384"
    "85868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7"
    "b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9ea"
    "f2f3f4f5f6f7f8f9faffda000c03010002110311003f00c5a28a2bcb3ef0"
    "ffd9")

_JPEG_SOF = {0xC0, 0xC1, 0xC2, 0xC3, 0xC5, 0xC6, 0xC7,
             0xC9, 0xCA, 0xCB, 0xCD, 0xCE, 0xCF}


def _parse_png(data: bytes) -> Optional[ImageInfo]:
    if len(data) < 33 or not data.startswith(_PNG_SIG):
        return None
    length, ctype = struct.unpack(">I4s", data[8:16])
    if ctype != b"IHDR" or length != 13:
        return None
    ihdr = data[16:29]
    crc = struct.unpack(">I", data[29:33])[0]
    if zlib.crc32(b"IHDR" + ihdr) & 0xFFFFFFFF != crc:
        return None
    w, h, depth, color = struct.unpack(">IIBB", ihdr[:10])
    if not (0 < w <= 1 << 24 and 0 < h <= 1 << 24):
        return None
    if depth not in (1, 2, 4, 8, 16) or color not in (0, 2, 3, 4, 6):
        return None
    # body must at least reach an IEND marker
    if b"IEND" not in data[-16:] and b"IEND" not in data:
        return None
    return ImageInfo("PNG", w, h)


def _parse_jpeg(data: bytes) -> Optional[ImageInfo]:
    if len(data) < 4 or data[0:2] != b"\xff\xd8":
        return None
    i, n = 2, len(data)
    while i + 4 <= n:
        if data[i] != 0xFF:
            return None
        marker = data[i + 1]
        if marker == 0xD9:           # EOI before any SOF: no dimensions
            return None
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:  # standalone
            i += 2
            continue
        if i + 4 > n:
            return None
        seglen = struct.unpack(">H", data[i + 2:i + 4])[0]
        if seglen < 2 or i + 2 + seglen > n:
            return None
        if marker in _JPEG_SOF:
            if seglen < 7:
                return None
            h, w = struct.unpack(">HH", data[i + 5:i + 9])
            if w == 0 or h == 0:
                return None
            # a scan must follow somewhere, and the stream must end in EOI
            if b"\xff\xd9" not in data[-4:]:
                return None
            return ImageInfo("JPEG", w, h)
        i += 2 + seglen
    return None


def _parse_gif(data: bytes) -> Optional[ImageInfo]:
    if len(data) < 13 or data[:6] not in (b"GIF87a", b"GIF89a"):
        return None
    w, h = struct.unpack("<HH", data[6:10])
    if w == 0 or h == 0:
        return None
    return ImageInfo("GIF", w, h)


def _parse_bmp(data: bytes) -> Optional[ImageInfo]:
    if len(data) < 26 or data[:2] != b"BM":
        return None
    size = struct.unpack("<I", data[2:6])[0]
    if size > len(data) + 8:  # declared size way past the body: truncated
        return None
    w, h = struct.unpack("<ii", data[18:26])
    if w <= 0 or h == 0:
        return None
    return ImageInfo("BMP", w, abs(h))


def probe_image(data: bytes) -> Optional[ImageInfo]:
    """Validate a slide body; None when corrupt/truncated/unknown."""
    for parser in (_parse_png, _parse_jpeg, _parse_gif, _parse_bmp):
        info = parser(data)
        if info is not None:
            return info
    return None
