"""A TensorBoard event file writer from the standard library: the port's
counterpart of the tensorboardX SummaryWriter that the JAX package's
utils/logging.py mirrors its scalars and panels into when
trainer.tensorboard is set.

An event file is a sequence of TFRecords: the record's length as a
little-endian u64, the masked CRC32C of those 8 bytes as a u32, the record,
then the masked CRC32C of the record. Each record is one serialised
`Event` protocol buffer (tensorflow/core/util/event.proto), encoded here by
hand:
  Event    wall_time = 1 (double), step = 2 (int64), file_version = 3
           (string), summary = 5 (Summary);
  Summary  value = 1 (repeated Value);
  Value    tag = 1 (string), simple_value = 2 (float), image = 4 (Image);
  Image    height = 1, width = 2, colorspace = 3 (int32), encoded_image_string
           = 4 (bytes: PNG).
The first record holds file_version "brain.Event:2", as TensorFlow's and
tensorboardX's writers begin.
"""
from __future__ import annotations

import socket
import struct
import time
from pathlib import Path

import numpy as np

from ..data.io import encode_png


def _crc32c_table():
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC32C = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli, reflected polynomial 0x82F63B78)."""
    crc = 0xFFFFFFFF
    table = _CRC32C
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """TFRecord's masked CRC: the CRC rotated right by 15 bits plus a
    constant, modulo 2^32."""
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def record(data: bytes) -> bytes:
    """One TFRecord framing `data`."""
    length = struct.pack("<Q", len(data))
    return (length + struct.pack("<I", masked_crc32c(length)) + data
            + struct.pack("<I", masked_crc32c(data)))


def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1  # int64 fields encode negatives as 10-byte varints
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _bytes_field(field: int, data: bytes) -> bytes:
    return _key(field, 2) + _varint(len(data)) + data


def _int_field(field: int, n: int) -> bytes:
    return _key(field, 0) + _varint(n)


def event(wall_time: float, step: int = 0, summary: bytes = None,
          file_version: str = None) -> bytes:
    """A serialised Event."""
    out = _key(1, 1) + struct.pack("<d", wall_time)
    if step:
        out += _int_field(2, step)
    if file_version is not None:
        out += _bytes_field(3, file_version.encode())
    if summary is not None:
        out += _bytes_field(5, summary)
    return out


def scalar_value(tag: str, value: float) -> bytes:
    """A serialised Summary.Value holding simple_value."""
    return _bytes_field(1, tag.encode()) + _key(2, 5) + struct.pack("<f", value)


def image_value(tag: str, img: np.ndarray) -> bytes:
    """A serialised Summary.Value holding an Image: uint8 [H, W, C] as PNG
    (this package's encoder), colorspace C."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    image = (_int_field(1, h) + _int_field(2, w) + _int_field(3, c)
             + _bytes_field(4, encode_png(img)))
    return _bytes_field(1, tag.encode()) + _bytes_field(4, image)


def summary(*values: bytes) -> bytes:
    """A serialised Summary of serialised Values."""
    return b"".join(_bytes_field(1, v) for v in values)


class EventWriter:
    """Appends events to logdir/events.out.tfevents.<time>.<host> (the
    directory made, the file begun with its file_version event, on the
    first write), flushing each."""

    def __init__(self, logdir):
        self.logdir = Path(logdir)
        self.path = None

    def _write(self, data: bytes) -> None:
        if self.path is None:
            self.logdir.mkdir(parents=True, exist_ok=True)
            now = time.time()
            self.path = self.logdir / f"events.out.tfevents.{int(now):010d}.{socket.gethostname()}"
            with open(self.path, "ab") as f:
                f.write(record(event(now, file_version="brain.Event:2")))
        with open(self.path, "ab") as f:
            f.write(record(data))

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        """One event holding the scalar as a simple_value."""
        self._write(event(time.time(), step, summary(scalar_value(tag, float(value)))))

    def add_image(self, tag: str, img: np.ndarray, step: int) -> None:
        """One event holding the uint8 [H, W, C] image as PNG."""
        self._write(event(time.time(), step, summary(image_value(tag, img))))
