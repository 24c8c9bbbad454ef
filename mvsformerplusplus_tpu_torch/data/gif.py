"""GIF: the first frame, read as PIL's `Image.open(f).convert("RGB")` and
as OpenCV's `imread` give it. The blocks are parsed here; the frame's LZW
data is decoded in the host library (native.gif_lzw_decode).

The two readers agree on the frame's own pixels and differ around them:
- PIL makes the image as large as the logical screen and the frame
  together, fills it with the frame's transparent index (0 where there is
  none), pastes the frame's indices (transparent ones included) and looks
  them up in the frame's table (the local one, else the global one;
  indices past the table black); a file with no table at all is gray, the
  index its level.
- OpenCV fills the logical screen with the global table's background
  colour (black without a global table) and draws the frame's pixels that
  are not transparent over it. It refuses a frame that leaves the screen,
  a background index or a pixel index past its table; a file without any
  table it misreads, and the port refuses it.
"""
from __future__ import annotations

import struct
from typing import Optional

import numpy as np

from . import native


def _table(data: bytes, pos: int, flags: int, name):
    """(colour table [N, 3] or None, position after it) for a screen or
    image descriptor's flags."""
    if not flags & 0x80:
        return None, pos
    n = 2 << (flags & 7)
    if pos + 3 * n > len(data):
        raise ValueError(f"{name}: truncated GIF colour table")
    return np.frombuffer(data, np.uint8, 3 * n, pos).reshape(n, 3), pos + 3 * n


def _sub_blocks(data: bytes, pos: int, name):
    """(the data of the sub-blocks at pos joined, position after their
    terminator)."""
    parts = []
    while True:
        if pos >= len(data):
            raise ValueError(f"{name}: truncated GIF (sub-blocks run past the end)")
        n = data[pos]
        if n == 0:
            return b"".join(parts), pos + 1
        parts.append(data[pos + 1:pos + 1 + n])
        pos += 1 + n


_INTERLACE = ((0, 8), (4, 8), (2, 4), (1, 2))


def decode(data: bytes, name, cv2_rules: bool) -> np.ndarray:
    """The first frame of a GIF -> uint8 [H, W, 3] RGB by PIL's rules or
    OpenCV's (module docstring)."""
    if len(data) < 13 or data[:6] not in (b"GIF87a", b"GIF89a"):
        raise ValueError(f"{name}: not a GIF file")
    sw, sh, flags, bg = struct.unpack("<HHBB", data[6:12])
    glob, pos = _table(data, 13, flags, name)
    transparency: Optional[int] = None
    while True:
        if pos >= len(data):
            raise ValueError(f"{name}: GIF without an image")
        block = data[pos]
        if block == 0x3B:
            raise ValueError(f"{name}: GIF without an image")
        if block == 0x21:
            label = data[pos + 1:pos + 2]
            body, pos = _sub_blocks(data, pos + 2, name)
            if label == b"\xf9" and len(body) >= 4:
                transparency = body[3] if body[0] & 1 else None
            continue
        if block != 0x2C:
            raise ValueError(f"{name}: corrupt GIF (block 0x{block:02x})")
        if pos + 10 > len(data):
            raise ValueError(f"{name}: truncated GIF image descriptor")
        left, top, fw, fh, iflags = struct.unpack("<HHHHB", data[pos + 1:pos + 10])
        local, pos = _table(data, pos + 10, iflags, name)
        if pos >= len(data):
            raise ValueError(f"{name}: truncated GIF image data")
        min_code = data[pos]
        lzw, pos = _sub_blocks(data, pos + 1, name)
        break
    if fw == 0 or fh == 0:
        raise ValueError(f"{name}: GIF frame of {fw} x {fh} pixels")
    native.check_pixels(max(sw, left + fw), max(sh, top + fh), name)
    if not 2 <= min_code <= 8:
        raise ValueError(f"{name}: GIF LZW minimum code size {min_code} (2-8)")
    idx = native.gif_lzw_decode(lzw, min_code, fw * fh, str(name)).reshape(fh, fw)
    if iflags & 0x40:
        order = [y for start, step in _INTERLACE for y in range(start, fh, step)]
        frame = np.empty_like(idx)
        frame[order] = idx
        idx = frame
    table = local if local is not None else glob
    if cv2_rules:
        return _cv2(idx, left, top, sw, sh, glob, table, bg, transparency, name)
    h, w = max(sh, top + fh), max(sw, left + fw)
    canvas = np.full((h, w), transparency or 0, np.uint8)
    canvas[top:top + fh, left:left + fw] = idx
    if table is None:
        return np.repeat(canvas[..., None], 3, axis=2)
    lut = np.zeros((256, 3), np.uint8)
    lut[:len(table)] = table
    return lut[canvas]


def _cv2(idx, left, top, sw, sh, glob, table, bg, transparency, name) -> np.ndarray:
    fh, fw = idx.shape
    if table is None:
        raise ValueError(f"{name}: GIF without a colour table, which OpenCV misreads")
    if left + fw > sw or top + fh > sh:
        raise ValueError(f"{name}: GIF frame past its logical screen, which OpenCV refuses")
    if glob is not None and bg >= len(glob):
        raise ValueError(f"{name}: GIF background index past its colour table, which OpenCV "
                         "refuses")
    opaque = idx != transparency if transparency is not None else np.ones_like(idx, bool)
    if idx[opaque].max(initial=0) >= len(table):
        raise ValueError(f"{name}: GIF pixel index past its colour table, which OpenCV refuses")
    canvas = np.zeros((sh, sw, 3), np.uint8)
    if glob is not None:
        canvas[:] = glob[bg]
    view = canvas[top:top + fh, left:left + fw]
    view[opaque] = table[idx[opaque]]
    return canvas
