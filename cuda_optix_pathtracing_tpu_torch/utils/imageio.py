"""Minimal pure-Python PNG read/write (stdlib zlib only).

The reference uses vendored stb for image IO (host_utils.cu:232-244,
core-parser.h:75-80). We implement the small PNG subset the framework
needs — 8/16-bit RGB/RGBA/gray, non-interlaced — with no third-party
dependency so the CLI works in a hermetic environment.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (
        struct.pack(">I", len(data))
        + tag
        + data
        + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
    )


def write_png(path: str, img: np.ndarray) -> None:
    """Write uint8 image (H,W), (H,W,1), (H,W,3) or (H,W,4)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError("write_png expects uint8 (use film.to_uint8)")
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    color_type = {1: 0, 3: 2, 4: 6}[c]
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    # filter byte 0 per scanline
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * c)], axis=1)
    idat = zlib.compress(raw.tobytes(), 6)
    with open(path, "wb") as f:
        f.write(_PNG_SIG)
        f.write(_chunk(b"IHDR", ihdr))
        f.write(_chunk(b"IDAT", idat))
        f.write(_chunk(b"IEND", b""))


def _unfilter(raw: np.ndarray, h: int, w: int, c: int, depth_bytes: int) -> np.ndarray:
    stride = w * c * depth_bytes
    bpp = c * depth_bytes
    out = np.zeros((h, stride), np.uint8)
    pos = 0
    for y in range(h):
        ftype = raw[pos]
        line = raw[pos + 1 : pos + 1 + stride].astype(np.int32)
        pos += 1 + stride
        prev = out[y - 1].astype(np.int32) if y > 0 else np.zeros(stride, np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 2:  # up
            cur = (line + prev) & 0xFF
        else:  # sub(1), average(3), paeth(4) need sequential passes
            cur = np.zeros(stride, np.int32)
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                b = prev[x]
                cc = prev[x - bpp] if x >= bpp else 0
                if ftype == 1:
                    pred = a
                elif ftype == 3:
                    pred = (a + b) >> 1
                else:  # paeth
                    p = a + b - cc
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
                    pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else cc)
                cur[x] = (line[x] + pred) & 0xFF
        out[y] = cur.astype(np.uint8)
    return out


def read_png(path: str) -> np.ndarray:
    """Read a non-interlaced 8/16-bit PNG → uint8/uint16 array (H,W,C).

    Fast path: PIL when importable (the pure-Python unfilter below is
    ~1.5 s/Mpixel); the stdlib-only reader remains the fallback and the
    readable specification.
    """
    try:
        from PIL import Image

        with Image.open(path) as im:
            if im.mode == "P":  # palette → RGB (matches the fallback reader)
                im = im.convert("RGB")
            arr = np.asarray(im)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        return arr
    except ImportError:
        pass
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIG:
        raise ValueError("not a PNG file")
    pos = 8
    idat = b""
    w = h = depth = color_type = None
    palette = None
    while pos < len(data):
        (ln,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        payload = data[pos + 8 : pos + 8 + ln]
        pos += 12 + ln
        if tag == b"IHDR":
            w, h, depth, color_type, _, _, interlace = struct.unpack(
                ">IIBBBBB", payload
            )
            if interlace:
                raise ValueError("interlaced PNG unsupported")
        elif tag == b"PLTE":
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color_type]
    if depth not in (8, 16):
        raise ValueError(f"bit depth {depth} unsupported")
    db = depth // 8
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    arr = _unfilter(raw, h, w, channels, db)
    if depth == 16:
        arr = arr.reshape(h, w, channels, 2)
        img = (arr[..., 0].astype(np.uint16) << 8) | arr[..., 1]
    else:
        img = arr.reshape(h, w, channels)
    if color_type == 3:
        img = palette[img[..., 0]]
    return img


def srgb_to_linear(img_uint: np.ndarray) -> np.ndarray:
    """Integer sRGB-encoded image → linear-light float32 in [0, 1]."""
    x = img_uint.astype(np.float32) / float(np.iinfo(img_uint.dtype).max)
    return np.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)
