"""PNG reading and writing with zlib and numpy, for machines without cv2 or
PIL.

``read_png_bgr`` returns what ``cv2.imread(path)`` returns for the files
SemanticKITTI ships (8-bit RGB, not interlaced): uint8 [H, W, 3] in BGR
order, every one of the five row filters undone. Any other kind of PNG
(16-bit, palette, grey, alpha, interlaced) raises. ``write_png_bgr`` writes
such a file with filter 0 on every row.

Filters 0-2 are undone with numpy on whole rows; Average (3) and Paeth (4)
depend on the reconstructed byte to their left and run a Python loop over
the row's bytes (about a millisecond a row).
"""

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunks(data, path):
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n:
            raise ValueError(f"{path}: truncated {kind!r} chunk")
        yield kind, body
        pos += 12 + n


def _average(line, prior, bpp):
    out = bytearray(line)
    for i in range(len(out)):
        left = out[i - bpp] if i >= bpp else 0
        out[i] = (out[i] + ((left + prior[i]) >> 1)) & 0xFF
    return out


def _paeth(line, prior, bpp):
    out = bytearray(line)
    for i in range(len(out)):
        if i >= bpp:
            a, c = out[i - bpp], prior[i - bpp]
        else:
            a = c = 0
        b = prior[i]
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (out[i] + pred) & 0xFF
    return out


def _unfilter(rows, W, bpp):
    """rows [H, 1 + W * bpp] uint8 (filter byte first) -> [H, W * bpp]."""
    H, stride = rows.shape[0], W * bpp
    out = np.empty((H, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(H):
        kind, line = rows[y, 0], rows[y, 1:]
        if kind == 0:
            cur = line
        elif kind == 1:  # Sub: a running sum per channel, modulo 256
            cur = (np.cumsum(line.reshape(W, bpp), 0, dtype=np.int64)
                   .astype(np.uint8).reshape(stride))
        elif kind == 2:  # Up
            cur = line + prior
        elif kind == 3:
            cur = np.frombuffer(_average(line.tobytes(), prior.tobytes(),
                                         bpp), np.uint8)
        elif kind == 4:
            cur = np.frombuffer(_paeth(line.tobytes(), prior.tobytes(),
                                       bpp), np.uint8)
        else:
            raise ValueError(f"PNG row {y}: unknown filter type {kind}")
        out[y] = cur
        prior = out[y]
    return out


def read_png_bgr(path):
    """An 8-bit RGB, non-interlaced PNG -> uint8 [H, W, 3], BGR (the array
    ``cv2.imread(path)`` gives)."""
    with open(path, "rb") as f:
        data = f.read()
    header, idat = None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError(f"{path}: no IHDR or IDAT chunk")
    W, H, depth, color, comp, filt, interlace = header
    if (depth, color, comp, filt, interlace) != (8, 2, 0, 0, 0):
        raise ValueError(
            f"{path}: only 8-bit RGB non-interlaced PNGs are read (bit depth "
            f"{depth}, colour type {color}, interlace {interlace})")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != H * (1 + 3 * W):
        raise ValueError(f"{path}: {raw.size} image bytes for {W}x{H}")
    rgb = _unfilter(raw.reshape(H, 1 + 3 * W), W, 3).reshape(H, W, 3)
    return np.ascontiguousarray(rgb[..., ::-1])


def _chunk(kind, body):
    return (len(body).to_bytes(4, "big") + kind + body
            + zlib.crc32(kind + body).to_bytes(4, "big"))


def write_png_bgr(path, image):
    """uint8 [H, W, 3] BGR -> an 8-bit RGB PNG, filter 0 on every row."""
    image = np.asarray(image)
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"need uint8 [H, W, 3], got {image.dtype} "
                         f"{image.shape}")
    H, W = image.shape[:2]
    rows = np.zeros((H, 1 + 3 * W), np.uint8)
    rows[:, 1:] = image[..., ::-1].reshape(H, 3 * W)
    with open(path, "wb") as f:
        f.write(_SIGNATURE
                + _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 2, 0, 0,
                                              0))
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + _chunk(b"IEND", b""))
