"""Logging of the port's commands (counterpart of casmtr_tpu/utils/
logging.py): ``get_logger``, at INFO in process 0 and at ERROR in the
other processes of a data-parallel group (``parallel.mesh``), and
``TensorBoardWriter``, scalars and figures in a TensorBoard event file.

The JAX package's writer is ``tf.summary``; this one writes the file with
the stdlib alone: records framed as TFRecord (the data's length as a
little-endian uint64, its masked CRC32C, the data, the data's masked
CRC32C), each an ``Event`` protobuf encoded here by hand.  The first event
holds ``file_version "brain.Event:2"``; scalars are ``Summary.Value``s of
``simple_value`` (TensorBoard's scalar plugin reads them as float32) and
figures ``Summary.Image``s holding a PNG (``utils/plotting.png_bytes``).
"""

from __future__ import annotations

import logging
import os
import socket
import struct
import sys
import time
from typing import Dict

import numpy as np

from casmtr_tpu_torch.parallel import comm

_configured = set()


def get_logger(name: str = "casmtr_tpu_torch") -> logging.Logger:
    """A logger to stderr, configured once per name: at INFO in process 0,
    at ERROR in the others."""
    lg = logging.getLogger(name)
    if name not in _configured:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s %(name)s: %(message)s"))
        lg.addHandler(handler)
        lg.setLevel(logging.INFO if comm.is_main_process() else logging.ERROR)
        _configured.add(name)
    return lg


# ---- CRC32C (Castagnoli, reflected polynomial 0x82F63B78) and TFRecord


def _crc_table():
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc_table()


def crc32c(data: bytes) -> int:
    """The CRC32C of ``data`` (RFC 3720's check value: b"123456789" gives
    0xE3069283)."""
    crc = 0xFFFFFFFF
    table = _CRC_TABLE
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """TFRecord's masked CRC32C: rotated right by 15 bits plus
    0xA282EAD8."""
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def tfrecord(data: bytes) -> bytes:
    """One TFRecord: length, its masked CRC32C, the data, its masked
    CRC32C."""
    length = struct.pack("<Q", len(data))
    return (length + struct.pack("<I", masked_crc32c(length)) + data
            + struct.pack("<I", masked_crc32c(data)))


# ---- protobuf wire format of event.proto / summary.proto


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        byte = n & 0x7F
        n >>= 7
        if n:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def _field(number: int, payload: bytes) -> bytes:
    """A length-delimited field (string, bytes or a message)."""
    return _varint(number << 3 | 2) + _varint(len(payload)) + payload


def _int_field(number: int, value: int) -> bytes:
    return _varint(number << 3) + _varint(value)


def _event(wall_time: float, step: int, file_version: str = None,
          summary: bytes = None) -> bytes:
    """An ``Event``: wall_time (1, double), step (2, int64) and either
    file_version (3) or summary (5)."""
    out = _varint(1 << 3 | 1) + struct.pack("<d", wall_time)
    out += _int_field(2, int(step))
    if file_version is not None:
        out += _field(3, file_version.encode())
    if summary is not None:
        out += _field(5, summary)
    return out


def _scalar_value(tag: str, value: float) -> bytes:
    """A ``Summary.Value``: tag (1) and simple_value (2, float)."""
    return (_field(1, tag.encode()) + _varint(2 << 3 | 5)
            + struct.pack("<f", value))


def _image_value(tag: str, png: bytes, height: int, width: int,
                channels: int) -> bytes:
    """A ``Summary.Value``: tag (1) and image (4), a ``Summary.Image`` of
    height (1), width (2), colorspace (3: the channels) and
    encoded_image_string (4)."""
    image = (_int_field(1, height) + _int_field(2, width)
             + _int_field(3, channels) + _field(4, png))
    return _field(1, tag.encode()) + _field(4, image)


class TensorBoardWriter:
    """Scalars and figures in ``log_dir/events.out.tfevents.<time>.<host>.
    <pid>``; does nothing off process 0 (``parallel.comm``)."""

    def __init__(self, log_dir: str):
        self._file = None
        if not comm.is_main_process():
            return
        os.makedirs(log_dir, exist_ok=True)
        name = (f"events.out.tfevents.{int(time.time()):010d}."
                f"{socket.gethostname()}.{os.getpid()}")
        self.path = os.path.join(log_dir, name)
        self._file = open(self.path, "wb")
        self._write(_event(time.time(), 0, file_version="brain.Event:2"))
        self.flush()

    def _write(self, data: bytes) -> None:
        self._file.write(tfrecord(data))

    def scalars(self, tag_values: Dict[str, float], step: int) -> None:
        """One event at ``step`` with a scalar per tag."""
        if self._file is None:
            return
        summary = b"".join(_field(1, _scalar_value(k, float(v)))
                           for k, v in tag_values.items())
        self._write(_event(time.time(), step, summary=summary))

    def figure(self, tag: str, raster: np.ndarray, step: int) -> None:
        """A figure at ``step``: ``raster`` (uint8 [H, W], [H, W, 3] or
        [H, W, 4], as ``utils/plotting.make_matching_figure`` draws it) as
        a PNG image summary."""
        if self._file is None:
            return
        from casmtr_tpu_torch.utils.plotting import png_bytes
        raster = np.asarray(raster)
        channels = 1 if raster.ndim == 2 else raster.shape[2]
        value = _image_value(tag, png_bytes(raster), raster.shape[0],
                            raster.shape[1], channels)
        self._write(_event(time.time(), step, summary=_field(1, value)))

    def flush(self) -> None:
        if self._file is not None:
            self._file.flush()

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None
