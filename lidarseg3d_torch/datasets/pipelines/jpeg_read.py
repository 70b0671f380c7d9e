"""Baseline JPEG files without cv2 or PIL: ``read_jpeg_bgr`` gives what
``cv2.imread(path)`` gives (libjpeg-turbo's decoder with OpenCV's
settings, bit for bit), ``write_jpeg_bgr`` writes what the synthetic
trees need.

The reader parses the markers here (SOI; APPn and COM skipped; DQT with
8-bit tables; SOF0 / SOF1; DHT; DRI; SOS; EOI), decodes each scan's
Huffman-coded data in C (``csrc/jpeg_huffman.c``: byte stuffing, restart
markers, interleaved and single-component scans, partial MCUs at the
right and bottom edges), and rebuilds the pixels with jpeg.py's decode
half: dequantisation, the ISLOW inverse DCT with libjpeg's range table,
fancy upsampling of the chroma (h2v2 for 4:2:0, h2v1 for 4:2:2, none for
4:4:4) and the fixed-point YCbCr -> BGR conversion; a one-component file
is grey, repeated into three channels. Progressive, arithmetic-coded,
lossless and 12-bit files, four components (CMYK / YCCK), RGB-coded
files, other sampling factors and an EXIF orientation other than 1 (which
cv2 would apply) raise.

The C helper is built at first use with the system compiler into
``lidarseg3d_torch/build/`` (``ops/cuda_build.py``) and loaded with
ctypes. If it cannot be built or loaded, the reader raises: there is no
slower fallback.

The writer: baseline, 4:2:0, JFIF, the standard Huffman tables and the
standard quantisation tables scaled to ``quality`` (libjpeg's scaling),
the forward half of jpeg.py.
"""

import ctypes

import numpy as np

from . import jpeg

# zig-zag position -> natural (row-major) index of an 8x8 block
ZIGZAG = np.array(sorted(range(64), key=lambda n: (
    n // 8 + n % 8, n // 8 if (n // 8 + n % 8) % 2 else n % 8)), np.int64)

# the standard Huffman tables (T.81 Annex K.3): counts of the code lengths
# 1-16 and the symbols in code order
DC_LUMA = ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0), range(12))
DC_CHROMA = ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0), range(12))
AC_LUMA = ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125), bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a434445464748494a"
    "535455565758595a636465666768696a737475767778797a838485868788898a"
    "92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6"
    "c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa"))
AC_CHROMA = ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119),
             bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa"))

_ERRORS = {-1: "a Huffman table is invalid", -2: "a Huffman code is invalid",
           -3: "a restart marker is missing", -4: "too many components",
           -5: "the output buffer is full"}
_P = ctypes.c_void_p
_I32 = ctypes.c_int32
_I64 = ctypes.c_int64


def _lib():
    from ...ops import cuda_build

    try:
        return cuda_build.load("jpeg_huffman", {
            "jpeg_decode_scan": [_P, _I64, _I32, _P, _P, _P, _P, _P, _I32, _P,
                                 _P, _I32, _I32, _I32, _P],
            "jpeg_encode_scan": [_I32, _P, _P, _P, _P, _P, _P, _P, _I32,
                                 _I32, _P, _P, _I64]}, restype=_I64)
    except (RuntimeError, OSError) as e:
        raise RuntimeError(f"the JPEG entropy coder (csrc/jpeg_huffman.c) "
                           f"could not be built or loaded: {e}") from e


def _ptr(a):
    return ctypes.c_void_p(a.ctypes.data)


def _i32(values):
    return np.ascontiguousarray(values, np.int32)


def _ptrs(arrays):
    return (ctypes.c_void_p * len(arrays))(*[a.ctypes.data for a in arrays])


class _Frame:
    """What the markers say: quantisation tables, Huffman tables, the
    frame header, the restart interval, and each component's coefficient
    blocks as the scans fill them."""

    def __init__(self):
        self.qt, self.ht = {}, {}
        self.restart = 0
        self.comps = None
        self.adobe_transform = None

    def start(self, seg):
        precision = seg[0]
        if precision != 8:
            raise NotImplementedError(f"{precision}-bit JPEG")
        self.H, self.W = int.from_bytes(seg[1:3], "big"), int.from_bytes(
            seg[3:5], "big")
        n = seg[5]
        if self.H == 0 or self.W == 0:
            raise NotImplementedError("JPEG with the height in a DNL marker")
        if n not in (1, 3):
            raise NotImplementedError(f"JPEG with {n} components (only grey "
                                      "and YCbCr are read)")
        self.comps = [dict(id=seg[6 + 3 * i], h=seg[7 + 3 * i] >> 4,
                           v=seg[7 + 3 * i] & 15, tq=seg[8 + 3 * i])
                      for i in range(n)]
        self.hmax = max(c["h"] for c in self.comps)
        self.vmax = max(c["v"] for c in self.comps)
        mx, my = -(-self.W // (8 * self.hmax)), -(-self.H // (8 * self.vmax))
        for c in self.comps:
            if c["h"] not in (1, 2) or c["v"] not in (1, 2):
                raise NotImplementedError(
                    f"JPEG sampling factors {c['h']}x{c['v']}")
            # the MCU-padded block grid; a component's own size in samples
            c["blocks"] = np.zeros((my * c["v"], mx * c["h"], 64), np.int16)
            c["width"] = -(-self.W * c["h"] // self.hmax)
            c["height"] = -(-self.H * c["v"] // self.vmax)
            c["scanned"] = False
        if n == 3 and [c["id"] for c in self.comps] == [82, 71, 66]:
            raise NotImplementedError("RGB-coded JPEG")

    def scan(self, seg, data):
        """Decode the scan that starts at ``data``; -> bytes it used."""
        if self.comps is None:
            raise ValueError("JPEG scan before the frame header")
        n = seg[0]
        by_id = {c["id"]: c for c in self.comps}
        comps = [by_id[seg[1 + 2 * i]] for i in range(n)]
        tables = [(seg[2 + 2 * i] >> 4, seg[2 + 2 * i] & 15)
                  for i in range(n)]
        ss, se, ahal = seg[1 + 2 * n: 4 + 2 * n]
        if (ss, se, ahal) != (0, 63, 0):
            raise NotImplementedError("progressive JPEG scan")
        keys = sorted({(0, td) for td, _ in tables}
                      | {(1, ta) for _, ta in tables})
        missing = [k for k in keys if k not in self.ht]
        if missing:
            raise ValueError(f"JPEG scan uses undefined Huffman tables "
                             f"{missing}")
        bits = np.zeros((len(keys), 17), np.uint8)
        vals = np.zeros((len(keys), 256), np.uint8)
        for i, k in enumerate(keys):
            bits[i, 1:], v = self.ht[k]
            vals[i, :len(v)] = v
        if n == 1:
            c = comps[0]
            mx, my = -(-c["width"] // 8), -(-c["height"] // 8)
        else:
            mx = -(-self.W // (8 * self.hmax))
            my = -(-self.H // (8 * self.vmax))
        buf = np.frombuffer(data, np.uint8)
        # the int32 arguments stay referenced until the call returns
        args = [_i32(a) for a in (
            [c["h"] for c in comps], [c["v"] for c in comps],
            [keys.index((0, td)) for td, _ in tables],
            [keys.index((1, ta)) for _, ta in tables],
            [c["blocks"].shape[1] for c in comps])]
        used = _lib().jpeg_decode_scan(
            _ptr(buf), len(buf), n, *map(_ptr, args), len(keys), _ptr(bits),
            _ptr(vals), mx, my, self.restart,
            _ptrs([c["blocks"] for c in comps]))
        if used < 0:
            raise ValueError(f"corrupt JPEG data: {_ERRORS[used]}")
        for c in comps:
            c["scanned"] = True
        return used

    def pixels(self):
        if self.comps is None or not all(c["scanned"] for c in self.comps):
            raise ValueError("JPEG without a frame or a scan of every "
                             "component")
        planes = []
        for c in self.comps:
            if c["tq"] not in self.qt:
                raise ValueError(f"JPEG quantisation table {c['tq']} "
                                 "undefined")
            blk = c["blocks"].astype(np.int32).reshape(
                *c["blocks"].shape[:2], 8, 8)
            plane = jpeg._unblock(jpeg.reconstruct(blk, self.qt[c["tq"]]))
            plane = plane[:c["height"], :c["width"]]
            fx, fy = self.hmax // c["h"], self.vmax // c["v"]
            if (fx, fy) == (1, 1):
                planes.append(plane.astype(np.int32))
            elif (fx, fy) == (2, 2):
                planes.append(jpeg._upsample(plane, self.H, self.W))
            elif (fx, fy) == (2, 1):
                planes.append(jpeg._upsample_h2v1(plane, self.H, self.W))
            else:
                raise NotImplementedError(
                    f"JPEG chroma subsampled {fx}x{fy} (only 4:2:0, 4:2:2 "
                    "and 4:4:4 are read)")
        if len(planes) == 1:
            return np.repeat(planes[0].astype(np.uint8)[..., None], 3, -1)
        if self.adobe_transform == 0:
            raise NotImplementedError("RGB-coded JPEG (Adobe transform 0)")
        return jpeg._ycc_to_bgr(*planes)


def _exif_orientation(seg):
    """The orientation tag of an APP1 Exif segment, or None."""
    if not seg.startswith(b"Exif\0\0") or len(seg) < 14:
        return None
    tiff = seg[6:]
    order = "little" if tiff[:2] == b"II" else "big"
    ifd = int.from_bytes(tiff[4:8], order)
    if ifd + 2 > len(tiff):
        return None
    for i in range(int.from_bytes(tiff[ifd:ifd + 2], order)):
        e = ifd + 2 + 12 * i
        if e + 12 > len(tiff):
            break
        if int.from_bytes(tiff[e:e + 2], order) == 0x0112:
            return int.from_bytes(tiff[e + 8:e + 10], order)
    return None


def decode_jpeg_bgr(data):
    """Baseline JPEG bytes -> uint8 BGR [H, W, 3], as cv2.imdecode(...,
    cv2.IMREAD_COLOR) gives them."""
    data = bytes(data)
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG file (no SOI marker)")
    frame, pos = _Frame(), 2
    while True:
        pos = data.find(b"\xff", pos)
        if pos < 0 or pos + 1 >= len(data):
            raise ValueError("JPEG ends before its EOI marker")
        marker = data[pos + 1]
        if marker == 0xFF or marker == 0 or 0xD0 <= marker <= 0xD7:
            pos += 1  # fill byte, stuffed byte or a stray restart marker
            continue
        if marker == 0xD9:
            return frame.pixels()
        length = int.from_bytes(data[pos + 2:pos + 4], "big")
        seg = data[pos + 4:pos + 2 + length]
        pos += 2 + length
        if marker == 0xDB:
            while seg:
                if seg[0] >> 4:
                    raise NotImplementedError("16-bit JPEG quantisation "
                                              "table")
                table = np.zeros(64, np.int32)
                table[ZIGZAG] = np.frombuffer(seg[1:65], np.uint8)
                frame.qt[seg[0] & 15] = table.reshape(8, 8)
                seg = seg[65:]
        elif marker == 0xC4:
            while seg:
                counts = tuple(seg[1:17])
                n = sum(counts)
                frame.ht[(seg[0] >> 4, seg[0] & 15)] = (
                    counts, np.frombuffer(seg[17:17 + n], np.uint8))
                seg = seg[17 + n:]
        elif marker in (0xC0, 0xC1):
            frame.start(seg)
        elif 0xC2 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            raise NotImplementedError(
                f"JPEG frame type SOF{marker - 0xC0} (progressive, lossless "
                "or arithmetic-coded)")
        elif marker == 0xDD:
            frame.restart = int.from_bytes(seg[:2], "big")
        elif marker == 0xDA:
            pos += frame.scan(seg, data[pos:])
        elif marker == 0xEE and seg.startswith(b"Adobe") and len(seg) > 11:
            frame.adobe_transform = seg[11]
        elif marker == 0xE1 and _exif_orientation(seg) not in (None, 1):
            raise NotImplementedError(
                f"JPEG with EXIF orientation {_exif_orientation(seg)} (cv2 "
                "would rotate it)")
        elif 0xE0 <= marker <= 0xEF or marker == 0xFE:
            pass
        else:
            raise NotImplementedError(f"JPEG marker 0x{marker:02X}")


def read_jpeg_bgr(path):
    """uint8 BGR [H, W, 3] of a baseline JPEG file, as cv2.imread(path)."""
    with open(path, "rb") as f:
        return decode_jpeg_bgr(f.read())


def _codes(counts, symbols):
    """Huffman code and length of each symbol (canonical, T.81 Annex C)."""
    code, size = np.zeros(256, np.uint32), np.zeros(256, np.uint8)
    symbols, k, c = list(symbols), 0, 0
    for length, n in enumerate(counts, 1):
        for _ in range(n):
            code[symbols[k]], size[symbols[k]] = c, length
            k += 1
            c += 1
        c <<= 1
    return code, size


def _segment(marker, payload):
    return bytes([0xFF, marker]) + (len(payload) + 2).to_bytes(2, "big") \
        + payload


def encode_jpeg_bgr(image, quality=95):
    """uint8 BGR [H, W, 3] -> baseline JPEG bytes at ``quality`` (1-100):
    4:2:0, JFIF, the standard tables."""
    image = np.asarray(image)
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
        raise ValueError("write_jpeg_bgr takes uint8 [H, W, 3]")
    H, W = image.shape[:2]
    luma_t = jpeg.quant_table(jpeg.LUMA_TABLE, quality)
    chroma_t = jpeg.quant_table(jpeg.CHROMA_TABLE, quality)
    src = image.astype(np.int64)
    y, cb, cr = jpeg._rgb_to_ycc(src[..., 2], src[..., 1], src[..., 0])
    mx, my = -(-W // 16), -(-H // 16)  # 16x16 MCUs
    ch, cw = my * 8, mx * 8
    planes = [(y, luma_t, my * 16, mx * 16),
              (jpeg._downsample(cb, -(-H // 2), cw), chroma_t, ch, cw),
              (jpeg._downsample(cr, -(-H // 2), cw), chroma_t, ch, cw)]
    coefs = [np.ascontiguousarray(jpeg.quantize(jpeg._blocks(plane, r, c),
                                                table).reshape(
        r // 8, c // 8, 64).astype(np.int16))
        for plane, table, r, c in planes]
    code = np.zeros((4, 256), np.uint32)
    size = np.zeros((4, 256), np.uint8)
    for i, t in enumerate((DC_LUMA, AC_LUMA, DC_CHROMA, AC_CHROMA)):
        code[i], size[i] = _codes(*t)
    cap = 2 * sum(a.size for a in coefs) + 1024
    out = np.empty(cap, np.uint8)
    # per component: h, v, DC table, AC table, blocks a row
    args = [_i32(a) for a in ([2, 1, 1], [2, 1, 1], [0, 2, 2], [1, 3, 3],
                              [a.shape[1] for a in coefs])]
    used = _lib().jpeg_encode_scan(3, *map(_ptr, args), _ptr(code),
                                   _ptr(size), mx, my, _ptrs(coefs),
                                   _ptr(out), cap)
    if used < 0:
        raise RuntimeError(f"JPEG encoding failed: {_ERRORS[used]}")
    dqt = b"".join(bytes([i]) + t.reshape(-1)[ZIGZAG].astype(
        np.uint8).tobytes() for i, t in enumerate((luma_t, chroma_t)))
    dht = b"".join(bytes([tc]) + bytes(counts) + bytes(symbols)
                   for tc, (counts, symbols) in zip(
                       (0x00, 0x10, 0x01, 0x11),
                       (DC_LUMA, AC_LUMA, DC_CHROMA, AC_CHROMA)))
    sof = bytes([8]) + H.to_bytes(2, "big") + W.to_bytes(2, "big") \
        + bytes([3, 1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])
    sos = bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])
    return (b"\xff\xd8"
            + _segment(0xE0, b"JFIF\0\x01\x01\0\0\x01\0\x01\0\0")
            + _segment(0xDB, dqt) + _segment(0xC0, sof)
            + _segment(0xC4, dht) + _segment(0xDA, sos)
            + out[:used].tobytes() + b"\xff\xd9")


def write_jpeg_bgr(path, image, quality=95):
    """Write uint8 BGR [H, W, 3] to ``path`` as a baseline JPEG
    (``encode_jpeg_bgr``)."""
    with open(path, "wb") as f:
        f.write(encode_jpeg_bgr(image, quality))
