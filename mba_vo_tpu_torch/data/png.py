"""PNG reading and writing with the standard library only.

The command line reads and writes 8-bit grey frames (PIL mode ``L``) and
16-bit grey depth maps (PIL mode ``I;16``, the ETH3D contract of depth x
5000), and writes 8-bit RGB overlays (PIL mode ``RGB``). This module covers
exactly those: it reads colour type 0 at bit depth 8 or 16, and writes
colour type 0 at 8 or 16 bits and colour type 2 at 8 bits, not interlaced.
Reading undoes the five row filters
of the PNG specification (0 none, 1 sub, 2 up, 3 average, 4 Paeth); writing
uses filter 0 on every row. ``zlib`` inflates and deflates the image data
and ``struct`` packs the chunks.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunks(data: bytes):
    """(type, payload) of every chunk after the signature, CRCs checked."""
    pos = len(SIGNATURE)
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG chunk {kind!r}: CRC mismatch")
        yield kind, body
        pos += 12 + length
        if kind == b"IEND":
            return


def _paeth_row(cur: bytearray, prior: bytes, bpp: int) -> None:
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = prior[i]
        c = prior[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        if pa <= pb and pa <= pc:
            pred = a
        elif pb <= pc:
            pred = b
        else:
            pred = c
        cur[i] = (cur[i] + pred) & 0xFF


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """[height, stride] uint8 scanlines with the row filters undone."""
    rows = np.empty((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        start = y * (stride + 1)
        ftype = raw[start]
        line = np.frombuffer(raw, np.uint8, stride, start + 1)
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:
            # sub: a running sum over each byte lane, modulo 256
            lanes = line.reshape(-1, bpp).astype(np.uint64)
            cur = (np.cumsum(lanes, axis=0) & 0xFF).astype(np.uint8).reshape(-1)
        elif ftype == 2:
            cur = line + prior
        elif ftype == 3:
            buf = bytearray(line.tobytes())
            for i in range(stride):
                left = buf[i - bpp] if i >= bpp else 0
                buf[i] = (buf[i] + ((left + int(prior[i])) >> 1)) & 0xFF
            cur = np.frombuffer(bytes(buf), np.uint8)
        elif ftype == 4:
            buf = bytearray(line.tobytes())
            _paeth_row(buf, prior.tobytes(), bpp)
            cur = np.frombuffer(bytes(buf), np.uint8)
        else:
            raise ValueError(f"PNG: unknown row filter {ftype}")
        rows[y] = cur
        prior = rows[y]
    return rows


def read_png(path: str) -> np.ndarray:
    """A grey PNG as an array: [H, W] uint8 for 8-bit files, uint16 for
    16-bit files."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    width, height, depth, colour, _comp, _filt, interlace = header
    if colour != 0 or depth not in (8, 16):
        raise ValueError(
            f"{path}: colour type {colour} at bit depth {depth}; only 8- and "
            "16-bit grey PNGs are supported")
    if interlace:
        raise ValueError(f"{path}: interlaced PNGs are not supported")
    bpp = depth // 8
    rows = _unfilter(zlib.decompress(b"".join(idat)), height, width * bpp, bpp)
    if depth == 8:
        return rows.reshape(height, width)
    return rows.reshape(height, width, 2).view(">u2")[..., 0].astype(np.uint16)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray) -> None:
    """Write [H, W] uint8 (8-bit grey), [H, W] uint16 (16-bit grey) or
    [H, W, 3] uint8 (8-bit RGB) as a PNG."""
    img = np.asarray(img)
    rgb = img.ndim == 3 and img.shape[2] == 3 and img.dtype == np.uint8
    if not rgb and (img.ndim != 2 or img.dtype not in (np.uint8, np.uint16)):
        raise ValueError(
            f"write_png takes a 2-D uint8 or uint16 array or an [H, W, 3] uint8 "
            f"array, not {img.dtype} {img.shape}")
    height, width = img.shape[:2]
    depth = 8 * img.dtype.itemsize
    rows = img.astype(">u2" if depth == 16 else np.uint8).view(np.uint8)
    rows = rows.reshape(height, -1)
    raw = np.concatenate([np.zeros((height, 1), np.uint8), rows], axis=1)
    header = struct.pack(">IIBBBBB", width, height, depth, 2 if rgb else 0, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(SIGNATURE + _chunk(b"IHDR", header)
                + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                + _chunk(b"IEND", b""))
