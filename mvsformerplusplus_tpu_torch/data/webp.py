"""WebP: the RIFF container parsed here, the bitstreams decoded in the host
library (csrc/host/webp.cpp, through data/native.py): lossless (VP8L) and
lossy (VP8, with its ALPH alpha plane) images, still or animated.

PIL 12 reads every WebP through libwebp's animation decoder and OpenCV
through libwebp as well, and the two agree (each checked in the tests): the
first frame, decoded into a canvas of the VP8X canvas size filled with
transparent black, its colour channels as libwebp gives them (lossy:
fancy-upsampled, fixed-point YUV -> RGB; alpha never multiplied in), the
alpha dropped. A file whose RIFF size runs past its end, or whose chunks do,
raises ValueError, as do corrupt bitstreams.
"""
from __future__ import annotations

import struct
from typing import Dict, List, Tuple

import numpy as np

from . import native


def _chunks(data: bytes, pos: int, end: int, name) -> List[Tuple[bytes, bytes]]:
    """The (fourcc, payload) chunks between pos and end, padding skipped."""
    out = []
    while pos + 8 <= end:
        fourcc = data[pos:pos + 4]
        (size,) = struct.unpack("<I", data[pos + 4:pos + 8])
        if pos + 8 + size > end:
            raise ValueError(f"{name}: truncated WebP ({fourcc.decode('latin-1')} chunk runs "
                             "past the end)")
        out.append((fourcc, data[pos + 8:pos + 8 + size]))
        pos += 8 + size + (size & 1)
    return out


def _image(chunks: Dict[bytes, bytes], name) -> Tuple[np.ndarray, bool]:
    """A frame's image chunks (VP8L, or VP8 with an optional ALPH) -> (RGBA
    uint8 [H, W, 4], whether it holds alpha)."""
    if b"VP8L" in chunks:
        body = chunks[b"VP8L"]
        if len(body) < 5 or body[0] != 0x2F:
            raise ValueError(f"{name}: corrupt WebP lossless header")
        (bits,) = struct.unpack("<I", body[1:5])
        w, h = (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1
        native.check_pixels(w, h, name)
        return native.webp_lossless_decode(body, w, h, str(name)), bool((bits >> 28) & 1)
    if b"VP8 " not in chunks:
        raise ValueError(f"{name}: WebP frame without a VP8 or VP8L bitstream")
    body = chunks[b"VP8 "]
    if len(body) < 10:
        raise ValueError(f"{name}: truncated WebP lossy frame header")
    w = struct.unpack("<H", body[6:8])[0] & 0x3FFF
    h = struct.unpack("<H", body[8:10])[0] & 0x3FFF
    native.check_pixels(w, h, name)
    rgba = np.full((h, w, 4), 255, np.uint8)
    rgba[..., :3] = native.webp_lossy_decode(body, w, h, str(name))
    if b"ALPH" in chunks:
        rgba[..., 3] = native.webp_alpha_decode(chunks[b"ALPH"], w, h, str(name))
    return rgba, b"ALPH" in chunks


def decode_rgba(data: bytes, name="<bytes>") -> np.ndarray:
    """A WebP file -> its first frame as uint8 [H, W, 4] RGBA on its canvas
    (transparent black where the frame does not reach)."""
    if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"WEBP":
        raise ValueError(f"{name}: not a WebP file")
    (riff,) = struct.unpack("<I", data[4:8])
    if riff + 8 > len(data):
        raise ValueError(f"{name}: truncated WebP ({len(data)} of {riff + 8} bytes)")
    chunks = _chunks(data, 12, riff + 8, name)
    if not chunks:
        raise ValueError(f"{name}: WebP without chunks")
    if chunks[0][0] != b"VP8X":
        rgba, _ = _image({chunks[0][0]: chunks[0][1]}, name)
        return rgba
    head = chunks[0][1]
    if len(head) < 10:
        raise ValueError(f"{name}: truncated WebP VP8X chunk")
    cw = int.from_bytes(head[4:7], "little") + 1
    ch = int.from_bytes(head[7:10], "little") + 1
    native.check_pixels(cw, ch, name)
    if head[0] & 0x02:  # animation: the first ANMF frame
        frames = [body for fourcc, body in chunks if fourcc == b"ANMF"]
        if not frames:
            raise ValueError(f"{name}: animated WebP without frames")
        f = frames[0]
        if len(f) < 16:
            raise ValueError(f"{name}: truncated WebP ANMF chunk")
        x, y = 2 * int.from_bytes(f[0:3], "little"), 2 * int.from_bytes(f[3:6], "little")
        fw, fh = int.from_bytes(f[6:9], "little") + 1, int.from_bytes(f[9:12], "little") + 1
        sub = dict(_chunks(f, 16, len(f), name))
    else:
        x = y = 0
        fw, fh = cw, ch
        sub = {fourcc: body for fourcc, body in chunks[1:]}
    rgba, _ = _image(sub, name)
    if rgba.shape[:2] != (fh, fw) or x + fw > cw or y + fh > ch:
        raise ValueError(f"{name}: WebP frame of {rgba.shape[1]} x {rgba.shape[0]} at ({x}, "
                         f"{y}) does not fit its {cw} x {ch} canvas")
    canvas = np.zeros((ch, cw, 4), np.uint8)
    canvas[y:y + fh, x:x + fw] = rgba
    return canvas


def decode(data: bytes, name) -> np.ndarray:
    """A WebP file -> uint8 [H, W, 3] RGB, the first frame's colour
    channels (PIL's and OpenCV's rules agree)."""
    return np.ascontiguousarray(decode_rgba(data, name)[..., :3])
