"""JPEG 2000: raw codestreams (J2K) and JP2 files, read as PIL's
`Image.open(f).convert("RGB")` and OpenCV's `imread` give them. The JP2
boxes (ihdr, colr, pclr, cmap, cdef) and the codestream's markers (SIZ,
COD, COC, QCD, QCC, POC, PPM, PPT, SOT, with TLM, PLM, PLT, CRG and COM
skipped, and RGN's region-of-interest shift) are parsed here, the tile
precedence rules applied (a tile's COC
over its COD over the main header's COC over its COD, and so for QCC /
QCD); each tile is decoded in the host library (native.j2k_decode_tile:
tier 2, tier 1, dequantisation, the inverse wavelet, RCT / ICT and the DC
level shift, OpenJPEG's arithmetic bit for bit).

Both readers decode with OpenJPEG and agree on 8-bit images: gray,
gray + alpha, RGB and RGBA, alpha dropped. They differ on
- one component deeper than 8 bits (by the JP2 ihdr, else the codestream):
  PIL's mode I;16, whose convert("RGB") saturates at 255 the sample
  shifted to 16 bits; OpenCV shifts down to 8 bits. Other precisions: PIL
  shifts to 8 bits (rounding when it shifts down), OpenCV shifts down;
- signed samples, precisions under 8 bits, images that do not start at the
  reference grid's origin (XOsiz, YOsiz) and gray codestreams without a
  JP2 header (OpenCV takes them for sRGB), which OpenCV refuses;
- palettes (pclr): PIL looks the indices up itself, OpenCV through
  OpenJPEG, which clamps indices to the palette.
Refused by name: subsampled components, a colour space other than sRGB
and greyscale (JP2 colr), channel definitions that reorder channels,
HTJ2K code-blocks, more than four
components, and the precinct sizes OpenJPEG rejects (an exponent of 0
above the lowest resolution).
"""
from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import native

_JP2_SIGNATURE = b"\x00\x00\x00\x0cjP  \r\n\x87\n"
_PROGRESSIONS = ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL")


def _boxes(data: bytes, pos: int, end: int, name) -> List[Tuple[bytes, bytes]]:
    out = []
    while pos + 8 <= end:
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        head = 8
        if length == 1:
            if pos + 16 > end:
                raise ValueError(f"{name}: truncated JP2 box header")
            (length,) = struct.unpack(">Q", data[pos + 8:pos + 16])
            head = 16
        elif length == 0:
            length = end - pos
        if length < head or pos + length > end:
            raise ValueError(f"{name}: truncated JP2 ({kind.decode('latin-1')} box runs past "
                             "the end)")
        out.append((kind, data[pos + head:pos + length]))
        pos += length
    return out


class _Coding:
    """One component's COD/COC parameters."""

    def __init__(self, numres, cblkw, cblkh, cblksty, qmfbid, precincts):
        self.numres, self.cblkw, self.cblkh = numres, cblkw, cblkh
        self.cblksty, self.qmfbid, self.precincts = cblksty, qmfbid, precincts


def _spcod(body: bytes, at: int, precinct_flag: bool, name) -> _Coding:
    if at + 5 > len(body):
        raise ValueError(f"{name}: truncated JPEG 2000 COD/COC marker")
    numres = body[at] + 1
    cblkw, cblkh = (body[at + 1] & 15) + 2, (body[at + 2] & 15) + 2
    cblksty, qmfbid = body[at + 3], body[at + 4]
    if numres > 33 or cblkw > 10 or cblkh > 10 or cblkw + cblkh > 12 or qmfbid > 1:
        raise ValueError(f"{name}: invalid JPEG 2000 coding parameters")
    if cblksty & 0x40:
        raise ValueError(f"{name}: HTJ2K (high-throughput) code-blocks, which the port does "
                         "not read")
    if precinct_flag:
        raw = body[at + 5:at + 5 + numres]
        if len(raw) < numres:
            raise ValueError(f"{name}: truncated JPEG 2000 precinct sizes")
        for i, b in enumerate(raw):
            if i and (not b & 15 or not b >> 4):
                raise ValueError(f"{name}: invalid JPEG 2000 precinct size (exponent 0 above "
                                 "the lowest resolution), which OpenJPEG rejects")
        precincts = [(b & 15, b >> 4) for b in raw]
    else:
        precincts = [(15, 15)] * numres
    return _Coding(numres, cblkw, cblkh, cblksty, qmfbid, precincts)


def _sqcd(body: bytes, at: int, name):
    """(guard bits, style, [(exponent, mantissa), ...]) of a QCD/QCC."""
    if at >= len(body):
        raise ValueError(f"{name}: truncated JPEG 2000 QCD/QCC marker")
    sq = body[at]
    style, guard = sq & 0x1F, sq >> 5
    rest = body[at + 1:]
    if style == 0:
        steps = [(b >> 3, 0) for b in rest]
    elif style in (1, 2):
        vals = struct.unpack(f">{len(rest) // 2}H", rest[:len(rest) // 2 * 2])
        steps = [(v >> 11, v & 0x7FF) for v in vals]
        if style == 1:
            steps = steps[:1]
    else:
        raise ValueError(f"{name}: JPEG 2000 quantization style {style}")
    if not steps:
        raise ValueError(f"{name}: JPEG 2000 QCD/QCC without step sizes")
    return guard, style, steps


def _stepsizes(quant, numres: int, name) -> List[Tuple[int, int]]:
    guard, style, steps = quant
    n = 3 * numres - 2
    if style == 1:
        e0, m0 = steps[0]
        return [(e0, m0)] + [(max(e0 - (b - 1) // 3, 0), m0) for b in range(1, n)]
    if len(steps) < n:
        raise ValueError(f"{name}: JPEG 2000 QCD/QCC with {len(steps)} step sizes for {n} "
                         "bands")
    return steps[:n]


def _poc(body: bytes, csiz: int) -> List[Tuple[int, ...]]:
    """POC entries (layer end, res start, res end, comp start, comp end,
    order)."""
    cb = 1 if csiz < 257 else 2
    size = 5 + 2 * cb
    out = []
    for at in range(0, len(body) - size + 1, size):
        rs = body[at]
        cs = body[at + 1] if cb == 1 else struct.unpack(">H", body[at + 1:at + 3])[0]
        (lye,) = struct.unpack(">H", body[at + 1 + cb:at + 3 + cb])
        re = body[at + 3 + cb]
        ce = body[at + 4 + cb] if cb == 1 else struct.unpack(">H", body[at + 4 + cb:at + 6 + cb])[0]
        if cb == 1 and ce == 0:
            ce = 256
        out.append((lye, rs, re, cs, ce, body[at + 4 + 2 * cb]))
    return out


class _Header:
    """The parameters a main or tile-part header sets."""

    def __init__(self):
        self.cod: Optional[Tuple[int, int, int, int, _Coding]] = None  # Scod, prog, layers, mct
        self.coc: Dict[int, _Coding] = {}
        self.qcd = None
        self.qcc: Dict[int, tuple] = {}
        self.poc: List[Tuple[int, ...]] = []
        self.ppt: List[Tuple[int, bytes]] = []
        self.rgn: Dict[int, int] = {}  # component -> ROI shift


def _marker_segments(data: bytes, pos: int, end: int, name, csiz: int, hdr: _Header,
                     main: bool, ppm: Optional[list] = None) -> int:
    """Parse the markers from pos up to SOT (main) or SOD (tile-part) into
    hdr; returns the position after that marker's code (SOT's or SOD's)."""
    cb = 1 if csiz < 257 else 2
    while True:
        if pos + 2 > end:
            raise ValueError(f"{name}: truncated JPEG 2000 codestream header")
        (code,) = struct.unpack(">H", data[pos:pos + 2])
        if code == (0xFF90 if main else 0xFF93):
            return pos + 2
        if pos + 4 > end:
            raise ValueError(f"{name}: truncated JPEG 2000 marker segment")
        (length,) = struct.unpack(">H", data[pos + 2:pos + 4])
        body = data[pos + 4:pos + 2 + length]
        if length < 2 or pos + 2 + length > end:
            raise ValueError(f"{name}: truncated JPEG 2000 marker segment 0x{code:04X}")
        if code == 0xFF52:
            if len(body) < 5:
                raise ValueError(f"{name}: truncated JPEG 2000 COD marker")
            scod, prog = body[0], body[1]
            (layers,) = struct.unpack(">H", body[2:4])
            if prog > 4 or layers == 0:
                raise ValueError(f"{name}: invalid JPEG 2000 COD (order {prog}, {layers} "
                                 "layers)")
            hdr.cod = (scod, prog, layers, body[4], _spcod(body, 5, bool(scod & 1), name))
        elif code == 0xFF53:
            comp = body[0] if cb == 1 else struct.unpack(">H", body[:2])[0]
            hdr.coc[comp] = _spcod(body, cb + 1, bool(body[cb] & 1), name)
        elif code == 0xFF5C:
            hdr.qcd = _sqcd(body, 0, name)
        elif code == 0xFF5D:
            comp = body[0] if cb == 1 else struct.unpack(">H", body[:2])[0]
            hdr.qcc[comp] = _sqcd(body, cb, name)
        elif code == 0xFF5F:
            hdr.poc += _poc(body, csiz)
        elif code == 0xFF5E:
            comp = body[0] if cb == 1 else struct.unpack(">H", body[:2])[0]
            if len(body) < cb + 2 or body[cb] != 0:
                raise ValueError(f"{name}: invalid JPEG 2000 RGN marker")
            hdr.rgn[comp] = body[cb + 1]
        elif code == 0xFF60 and main and ppm is not None:
            ppm.append((body[0], body[1:]))
        elif code == 0xFF61 and not main:
            hdr.ppt.append((body[0], body[1:]))
        elif code in (0xFF51, 0xFF4F, 0xFFD9):
            raise ValueError(f"{name}: corrupt JPEG 2000 codestream (marker 0x{code:04X} in a "
                             "header)")
        pos += 2 + length


def _ppm_headers(ppm: List[Tuple[int, bytes]]) -> List[bytes]:
    """PPM data -> per tile-part its packet headers (Nppm, Ippm runs)."""
    joined = b"".join(body for _, body in sorted(ppm, key=lambda z: z[0]))
    out, pos = [], 0
    while pos + 4 <= len(joined):
        (n,) = struct.unpack(">I", joined[pos:pos + 4])
        out.append(joined[pos + 4:pos + 4 + n])
        pos += 4 + n
    return out


def decode_codestream(cs: bytes, name="<bytes>"):
    """A J2K codestream -> (components [C] of int32 [H_c, W_c] on the image
    area, [(prec, signed, dx, dy)], (XOsiz, YOsiz))."""
    if cs[:4] != b"\xff\x4f\xff\x51":
        raise ValueError(f"{name}: not a JPEG 2000 codestream")
    (lsiz,) = struct.unpack(">H", cs[4:6])
    if 6 + lsiz - 2 > len(cs) or lsiz < 41:
        raise ValueError(f"{name}: truncated JPEG 2000 SIZ marker")
    (_, xsiz, ysiz, xo, yo, xt, yt, xto, yto, csiz) = struct.unpack(">HIIIIIIIIH", cs[6:42])
    if not 0 < csiz <= 16384 or 42 + 3 * csiz > 4 + lsiz:
        raise ValueError(f"{name}: invalid JPEG 2000 SIZ marker")
    comps = []
    for c in range(csiz):
        ssiz, dx, dy = cs[42 + 3 * c:45 + 3 * c]
        comps.append(((ssiz & 0x7F) + 1, ssiz >> 7, dx, dy))
    if (xo >= xsiz or yo >= ysiz or xt == 0 or yt == 0 or xto > xo or yto > yo
            or xto + xt <= xo or yto + yt <= yo
            or any(not 1 <= p <= 38 or dx == 0 or dy == 0 for p, _, dx, dy in comps)):
        raise ValueError(f"{name}: invalid JPEG 2000 image geometry")
    native.check_pixels(xsiz - xo, ysiz - yo, name)
    main = _Header()
    ppm: List[Tuple[int, bytes]] = []
    pos = _marker_segments(cs, 4 + lsiz, len(cs), name, csiz, main, True, ppm)
    if main.cod is None or main.qcd is None:
        raise ValueError(f"{name}: JPEG 2000 main header without COD or QCD")
    ntx, nty = -(-(xsiz - xto) // xt), -(-(ysiz - yto) // yt)
    tiles: Dict[int, list] = {}
    headers: Dict[int, _Header] = {}
    tile_ppm: Dict[int, List[bytes]] = {}
    ppm_parts = _ppm_headers(ppm) if ppm else None
    part_no = 0
    pos -= 2
    while pos + 2 <= len(cs):
        (code,) = struct.unpack(">H", cs[pos:pos + 2])
        if code == 0xFFD9:
            break
        if code != 0xFF90:
            raise ValueError(f"{name}: corrupt JPEG 2000 codestream (0x{code:04X} where a "
                             "tile-part starts)")
        if pos + 12 > len(cs):
            raise ValueError(f"{name}: truncated JPEG 2000 SOT marker")
        _, isot, psot, tpsot, _ = struct.unpack(">HHIBB", cs[pos + 2:pos + 12])
        if isot >= ntx * nty:
            raise ValueError(f"{name}: JPEG 2000 tile index {isot} of {ntx * nty}")
        end = pos + psot if psot else len(cs) - 2
        if end > len(cs):
            raise ValueError(f"{name}: truncated JPEG 2000 tile-part ({len(cs)} of {end} "
                             "bytes)")
        hdr = headers.setdefault(isot, _Header())
        if tpsot != 0:  # later tile-parts may carry POC and PPT only
            hdr_part = _Header()
            sod = _marker_segments(cs, pos + 12, end, name, csiz, hdr_part, False)
            hdr.poc += hdr_part.poc
            hdr.ppt += hdr_part.ppt
        else:
            sod = _marker_segments(cs, pos + 12, end, name, csiz, hdr, False)
        tiles.setdefault(isot, []).append(cs[sod:end])
        if ppm_parts is not None:
            if part_no >= len(ppm_parts):
                raise ValueError(f"{name}: JPEG 2000 PPM marker without headers for every "
                                 "tile-part")
            tile_ppm.setdefault(isot, []).append(ppm_parts[part_no])
        part_no += 1
        pos = end
    out = [np.zeros((_ceil(ysiz, dy) - _ceil(yo, dy), _ceil(xsiz, dx) - _ceil(xo, dx)), np.int32)
           for _, _, dx, dy in comps]
    # a tile without tile-parts stays zero, as in the image OpenJPEG hands PIL
    for t in sorted(tiles):
        tx, ty = t % ntx, t // ntx
        x0, y0 = max(xto + tx * xt, xo), max(yto + ty * yt, yo)
        x1, y1 = min(xto + (tx + 1) * xt, xsiz), min(yto + (ty + 1) * yt, ysiz)
        hdr = headers.get(t, _Header())
        scod, prog, layers, mct, _ = hdr.cod or main.cod
        params = [x0, y0, x1, y1, csiz, layers, mct, scod & 6]
        pocs = main.poc + hdr.poc
        if pocs:
            params += [len(pocs)] + [v for poc in pocs for v in poc]
        else:
            params += [1, layers, 0, 33, 0, csiz, prog]
        for c, (prec, sgnd, dx, dy) in enumerate(comps):
            coding = (hdr.coc.get(c) or (hdr.cod[4] if hdr.cod else None) or main.coc.get(c)
                      or main.cod[4])
            quant = hdr.qcc.get(c) or hdr.qcd or main.qcc.get(c) or main.qcd
            params += [dx, dy, prec, sgnd, coding.numres, coding.cblkw, coding.cblkh,
                       coding.cblksty, coding.qmfbid, hdr.rgn.get(c, main.rgn.get(c, 0)),
                       quant[0]]
            params += [v for pp in coding.precincts for v in pp]
            params += [v for st in _stepsizes(quant, coding.numres, name) for v in st]
        headers_data = None
        if ppm_parts is not None:
            headers_data = b"".join(tile_ppm.get(t, []))
        elif hdr.ppt:
            headers_data = b"".join(body for _, body in sorted(hdr.ppt, key=lambda z: z[0]))
        shapes = [(_ceil(y1, dy) - _ceil(y0, dy), _ceil(x1, dx) - _ceil(x0, dx))
                  for _, _, dx, dy in comps]
        planes = native.j2k_decode_tile(np.array(params, np.int32), b"".join(tiles.get(t, [])),
                                        headers_data, shapes, str(name))
        for (_, _, dx, dy), plane, target in zip(comps, planes, out):
            oy, ox = _ceil(y0, dy) - _ceil(yo, dy), _ceil(x0, dx) - _ceil(xo, dx)
            target[oy:oy + plane.shape[0], ox:ox + plane.shape[1]] = plane
    return out, comps, (xo, yo)


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _jp2(data: bytes, name):
    """A JP2 file -> (its codestream, colour space enum or None, palette
    [N, C] or None, the ihdr's bit depth)."""
    boxes = _boxes(data, 0, len(data), name)
    header = next((body for kind, body in boxes if kind == b"jp2h"), None)
    cs = next((body for kind, body in boxes if kind == b"jp2c"), None)
    if header is None or cs is None:
        raise ValueError(f"{name}: JP2 without a header or codestream box")
    enumcs, palette, bpc = None, None, None
    for kind, body in _boxes(header, 0, len(header), name):
        if kind == b"ihdr" and len(body) >= 11:
            bpc = (body[10] & 0x7F) + 1
        elif kind == b"colr" and len(body) >= 3:
            if body[0] == 1 and len(body) >= 7:
                (enumcs,) = struct.unpack(">I", body[3:7])
            elif enumcs is None:
                enumcs = -1
        elif kind == b"pclr" and len(body) >= 3:
            ne, npc = struct.unpack(">HB", body[:3])
            depths = [(b & 0x7F) + 1 for b in body[3:3 + npc]]
            if any(d > 8 for d in depths) or len(body) < 3 + npc + ne * npc:
                raise ValueError(f"{name}: JP2 palette deeper than 8 bits, which the port does "
                                 "not read")
            palette = np.frombuffer(body, np.uint8, ne * npc, 3 + npc).reshape(ne, npc)
        elif kind == b"cdef" and len(body) >= 2:
            (n,) = struct.unpack(">H", body[:2])
            defs = [struct.unpack(">HHH", body[2 + 6 * i:8 + 6 * i]) for i in range(n)]
            if any(cn != i or (typ == 0 and asoc != i + 1) for i, (cn, typ, asoc) in
                   enumerate(sorted(defs))):
                raise ValueError(f"{name}: JP2 channel definitions that reorder channels, which "
                                 "the port does not read")
    return cs, enumcs, palette, bpc


def decode(data: bytes, name, cv2_rules: bool) -> np.ndarray:
    """A JP2 file or J2K codestream -> uint8 [H, W, 3] RGB by PIL's rules or
    OpenCV's (module docstring)."""
    enumcs, palette, bpc = None, None, None
    jp2 = data[:12] == _JP2_SIGNATURE
    if jp2:
        cs, enumcs, palette, bpc = _jp2(data, name)
    else:
        cs = data
    planes, comps, (xo, yo) = decode_codestream(cs, name)
    # PIL's mode: I;16 for one component deeper than 8 bits (the JP2 ihdr's
    # depth, else the codestream's)
    sixteen = len(comps) == 1 and (bpc if bpc is not None else comps[0][0]) > 8
    if len(comps) > 4:
        raise ValueError(f"{name}: JPEG 2000 with {len(comps)} components, which PIL does not "
                         "read")
    if any(dx != 1 or dy != 1 for _, _, dx, dy in comps):
        raise ValueError(f"{name}: JPEG 2000 with subsampled components, which the port does "
                         "not read")
    if enumcs not in (None, 16, 17):
        raise ValueError(f"{name}: JP2 colour space {enumcs}, which the port does not read "
                         "(sRGB and greyscale)")
    if cv2_rules and (any(sg for _, sg, _, _ in comps) or xo or yo
                      or any(prec < 8 for prec, _, _, _ in comps)):
        raise ValueError(f"{name}: JPEG 2000 with signed samples, fewer than 8 bits or an image "
                         "offset, which OpenCV does not read")
    if cv2_rules and not jp2 and len(comps) < 3:
        raise ValueError(f"{name}: gray JPEG 2000 codestream without a JP2 colour space, which "
                         "OpenCV takes for sRGB and refuses")
    if palette is not None:
        index = planes[0].astype(np.int64)
        if cv2_rules:
            rgb = palette[np.clip(index, 0, len(palette) - 1)][..., :3]
        else:
            lut = np.zeros((256, palette.shape[1]), np.uint8)
            lut[:min(len(palette), 256)] = palette[:256]
            rgb = lut[np.clip(index, 0, 255)][..., :3]
        if rgb.shape[2] == 1:
            rgb = np.repeat(rgb, 3, axis=2)
        return np.ascontiguousarray(rgb)
    out = []
    for plane, (prec, sgnd, _, _) in zip(planes[:3], comps[:3]):
        v = plane.astype(np.int64) + ((1 << (prec - 1)) if sgnd else 0)
        if sixteen and not cv2_rules:
            # PIL's I;16 (the sample shifted to 16 bits), saturated by convert("RGB")
            shift = 16 - prec
            v = np.minimum((v << shift) if shift >= 0 else (v >> -shift), 255)
        elif prec > 8:
            v = (v >> (prec - 8)) if cv2_rules else ((v + (1 << (prec - 9))) >> (prec - 8)) & 0xFF
        elif prec < 8:
            v = (v << (8 - prec)) & 0xFF
        out.append(v.astype(np.uint8))
    if len(comps) <= 2:
        out = [out[0]] * 3
    return np.ascontiguousarray(np.stack(out, axis=-1))
