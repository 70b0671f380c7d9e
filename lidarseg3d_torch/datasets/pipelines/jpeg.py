"""The JPEG round trip of the colour augmentation in numpy: what
``cv2.imdecode(cv2.imencode(".jpg", image, [cv2.IMWRITE_JPEG_QUALITY,
q])[1], cv2.IMREAD_COLOR)`` returns, for machines without cv2 or PIL.

The augmentation keeps only the decoded pixels, so the lossless Huffman
coding between the two halves is left out here; jpeg_read.py puts it
back (in C) around the same halves to read and write JPEG files. Everything else follows
libjpeg(-turbo) with OpenCV's settings (baseline, 4:2:0, the accurate
integer DCT, fancy upsampling):

- encode: libjpeg's fixed-point RGB -> YCbCr (16 fraction bits); luma
  padded to whole 8x8 blocks and chroma to whole 16x16 MCUs by repeating
  the last column and row; chroma 2x2 averaged with the alternating bias
  1, 2, 1, 2, ... along a row; the standard luma and chroma tables scaled
  by ``quality_scaling(q)`` and clamped to [1, 255]; the ISLOW forward
  DCT (``jfdctint.c``) and round-half-up quantisation of its 8x-scaled
  output;
- decode: dequantisation, the ISLOW inverse DCT (``jidctint.c``) with its
  1024-entry range-limit table, h2v2 "fancy" (triangle) upsampling of the
  chroma with the last real row and column repeated (plain 2x2 repetition
  for images at most 4 pixels wide), and the fixed-point
  YCbCr -> RGB conversion.
"""

import numpy as np

# the standard tables of the JPEG specification (Annex K), natural order
LUMA_TABLE = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99,
], np.int64).reshape(8, 8)
CHROMA_TABLE = np.full((8, 8), 99, np.int64)
CHROMA_TABLE[:4, :4] = [[17, 18, 24, 47], [18, 21, 26, 66],
                        [24, 26, 56, 99], [47, 66, 99, 99]]

_SCALE = 16  # fraction bits of the colour conversions
_HALF = 1 << (_SCALE - 1)
_CONST = 13  # fraction bits of the DCT constants
_PASS1 = 2  # extra bits kept between the DCT's two passes


def _fix(x, bits=_SCALE):
    return int(x * (1 << bits) + 0.5)


(F0298, F0390, F0541, F0765, F0899, F1175, F1501, F1847, F1961, F2053,
 F2562, F3072) = (_fix(c, _CONST) for c in (
     0.298631336, 0.390180644, 0.541196100, 0.765366865, 0.899976223,
     1.175875602, 1.501321110, 1.847759065, 1.961570560, 2.053119869,
     2.562915447, 3.072711026))


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


def quality_scaling(q):
    """libjpeg's jpeg_quality_scaling: quality 1-100 -> percent."""
    q = min(max(int(q), 1), 100)
    return 5000 // q if q < 50 else 200 - 2 * q


def quant_table(basic, q):
    """A standard table scaled to quality q, clamped to baseline."""
    return np.clip((basic * quality_scaling(q) + 50) // 100, 1, 255)


def _odd_part(t0, t1, t2, t3):
    """The rotation shared by both DCTs' odd halves (figure 8 of the
    Loeffler et al. algorithm). Returns the four products + sums."""
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * F1175
    t0, t1, t2, t3 = t0 * F0298, t1 * F2053, t2 * F3072, t3 * F1501
    z1, z2 = z1 * -F0899, z2 * -F2562
    z3, z4 = z3 * -F1961 + z5, z4 * -F0390 + z5
    return t0 + z1 + z3, t1 + z2 + z4, t2 + z2 + z3, t3 + z1 + z4


def _fdct_1d(d, last):
    """One pass of jfdctint.c along the last axis of int64 d [..., 8]."""
    t0, t7 = d[..., 0] + d[..., 7], d[..., 0] - d[..., 7]
    t1, t6 = d[..., 1] + d[..., 6], d[..., 1] - d[..., 6]
    t2, t5 = d[..., 2] + d[..., 5], d[..., 2] - d[..., 5]
    t3, t4 = d[..., 3] + d[..., 4], d[..., 3] - d[..., 4]
    t10, t13, t11, t12 = t0 + t3, t0 - t3, t1 + t2, t1 - t2
    out = np.empty_like(d)
    if last:  # columns: undo the row pass's extra bits
        out[..., 0] = _descale(t10 + t11, _PASS1)
        out[..., 4] = _descale(t10 - t11, _PASS1)
        n = _CONST + _PASS1
    else:
        out[..., 0] = (t10 + t11) << _PASS1
        out[..., 4] = (t10 - t11) << _PASS1
        n = _CONST - _PASS1
    z1 = (t12 + t13) * F0541
    out[..., 2] = _descale(z1 + t13 * F0765, n)
    out[..., 6] = _descale(z1 - t12 * F1847, n)
    o7, o5, o3, o1 = _odd_part(t4, t5, t6, t7)
    out[..., 7], out[..., 5] = _descale(o7, n), _descale(o5, n)
    out[..., 3], out[..., 1] = _descale(o3, n), _descale(o1, n)
    return out


def _idct_1d(c, last):
    """One pass of jidctint.c along the last axis of int64 c [..., 8]."""
    z1 = (c[..., 2] + c[..., 6]) * F0541
    t2 = z1 - c[..., 6] * F1847
    t3 = z1 + c[..., 2] * F0765
    t0 = (c[..., 0] + c[..., 4]) << _CONST
    t1 = (c[..., 0] - c[..., 4]) << _CONST
    t10, t13, t11, t12 = t0 + t3, t0 - t3, t1 + t2, t1 - t2
    o0, o1, o2, o3 = _odd_part(c[..., 7], c[..., 5], c[..., 3], c[..., 1])
    n = _CONST + _PASS1 + 3 if last else _CONST - _PASS1
    out = np.empty_like(c)
    for i, (a, b) in enumerate(((t10, o3), (t11, o2), (t12, o1),
                                (t13, o0))):
        out[..., i] = _descale(a + b, n)
        out[..., 7 - i] = _descale(a - b, n)
    return out


# the IDCT's range limit: (x + 128) clamped to [0, 255] for x in
# [-384, 383], indexed by x & 1023 (libjpeg's post-IDCT table)
_RANGE = np.zeros(1024, np.uint8)
_RANGE[:128] = np.arange(128, 256)
_RANGE[128:512] = 255
_RANGE[896:] = np.arange(128)


def _blocks(plane, rows, cols):
    """[H, W] plane edge-padded to [rows, cols] -> [rows/8, cols/8, 8, 8]."""
    H, W = plane.shape
    p = np.pad(plane, ((0, rows - H), (0, cols - W)), mode="edge")
    return p.reshape(rows // 8, 8, cols // 8, 8).swapaxes(1, 2)


def quantize(blocks, table):
    """Samples [..., 8, 8] -> quantised DCT coefficients (int64, natural
    order), through the forward DCT and round-half-up quantisation."""
    d = _fdct_1d(blocks.astype(np.int64) - 128, last=False)
    d = _fdct_1d(d.swapaxes(-1, -2), last=True).swapaxes(-1, -2)
    div = table * 8  # the ISLOW output is scaled up by 8
    return np.sign(d) * ((np.abs(d) + div // 2) // div)


def reconstruct(coef, table):
    """Quantised coefficients [..., 8, 8] -> uint8 samples, through the
    dequantisation and the inverse DCT. int32 coefficients stay int32:
    the ISLOW arithmetic of 8-bit data fits 32 bits, as in libjpeg."""
    c = _idct_1d((coef * table).swapaxes(-1, -2), last=False)
    c = _idct_1d(c.swapaxes(-1, -2), last=True)
    return _RANGE[c & 1023]


def _code_plane(blocks, table):
    """Samples [..., 8, 8] -> decoded samples, through the forward DCT,
    quantisation, dequantisation and the inverse DCT."""
    return reconstruct(quantize(blocks, table), table)


def _unblock(blocks):
    nr, nc = blocks.shape[:2]
    return blocks.swapaxes(1, 2).reshape(nr * 8, nc * 8)


def _downsample(plane, rows, cols):
    """2x2 means of a full-size plane edge-padded to [2 rows, 2 cols], with
    the bias 1, 2, 1, 2, ... along each output row (jcsample.c)."""
    H, W = plane.shape
    p = np.pad(plane, ((0, 2 * rows - H), (0, 2 * cols - W)), mode="edge")
    s = p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2] + p[1::2, 1::2]
    return (s + 1 + (np.arange(cols) & 1)) >> 2


def _upsample(plane, H, W):
    """h2v2 fancy upsampling (jdsample.c) of the first ceil(H/2) x
    ceil(W/2) samples, the last row and column repeated past them ->
    [H, W]. libjpeg repeats each sample 2x2 instead when the chroma is at
    most 2 samples wide."""
    h, w = -(-H // 2), -(-W // 2)
    if w <= 2:
        return plane[:h, :w].repeat(2, 0).repeat(2, 1)[:H, :W].astype(
            np.int32)
    p = np.pad(plane[:h, :w].astype(np.int32), 1, mode="edge")
    near = 3 * p[1:-1]
    cols = np.empty((2 * h, w + 2), np.int32)
    cols[0::2] = near + p[:-2]  # output row 2i leans on input row i - 1
    cols[1::2] = near + p[2:]
    out = np.empty((2 * h, 2 * w), np.int32)
    out[:, 0::2] = (3 * cols[:, 1:-1] + cols[:, :-2] + 8) >> 4
    out[:, 1::2] = (3 * cols[:, 1:-1] + cols[:, 2:] + 7) >> 4
    return out[:H, :W]


def _upsample_h2v1(plane, H, W):
    """h2v1 fancy upsampling (jdsample.c) of the first H x ceil(W/2)
    samples, the last column repeated past them -> [H, W]; plain 2x
    repetition when the chroma is at most 2 samples wide."""
    w = -(-W // 2)
    if w <= 2:
        return plane[:H, :w].repeat(2, 1)[:, :W].astype(np.int32)
    p = np.pad(plane[:H, :w].astype(np.int32), ((0, 0), (1, 1)),
               mode="edge")
    near = 3 * p[:, 1:-1]
    out = np.empty((H, 2 * w), np.int32)
    out[:, 0::2] = (near + p[:, :-2] + 1) >> 2
    out[:, 1::2] = (near + p[:, 2:] + 2) >> 2
    return out[:, :W]


def _rgb_to_ycc(r, g, b):
    y = (_fix(0.299) * r + _fix(0.587) * g + _fix(0.114) * b
         + _HALF) >> _SCALE
    off = (128 << _SCALE) + _HALF - 1
    cb = (-_fix(0.16874) * r - _fix(0.33126) * g + _fix(0.5) * b
          + off) >> _SCALE
    cr = (_fix(0.5) * r - _fix(0.41869) * g - _fix(0.08131) * b
          + off) >> _SCALE
    return y, cb, cr


def _ycc_to_bgr(y, cb, cr):
    x_b, x_r = cb - 128, cr - 128
    r = y + ((_fix(1.402) * x_r + _HALF) >> _SCALE)
    g = y + ((-_fix(0.34414) * x_b + _HALF - _fix(0.71414) * x_r)
             >> _SCALE)
    b = y + ((_fix(1.772) * x_b + _HALF) >> _SCALE)
    return np.clip(np.stack([b, g, r], -1), 0, 255).astype(np.uint8)


def jpeg_round_trip(image, quality):
    """uint8 BGR [H, W, 3] -> the same image JPEG-encoded at ``quality``
    (1-100) and decoded, as cv2's imencode / imdecode give it."""
    H, W = image.shape[:2]
    src = image.astype(np.int64)
    y, cb, cr = _rgb_to_ycc(src[..., 2], src[..., 1], src[..., 0])
    luma_t = quant_table(LUMA_TABLE, quality)
    chroma_t = quant_table(CHROMA_TABLE, quality)
    y = _unblock(_code_plane(_blocks(y, -(-H // 8) * 8, -(-W // 8) * 8),
                             luma_t))[:H, :W]
    crows, ccols = -(-H // 16) * 8, -(-W // 16) * 8
    chroma = []
    for plane in (cb, cr):
        small = _downsample(plane, -(-H // 2), ccols)
        small = _unblock(_code_plane(_blocks(small, crows, ccols), chroma_t))
        chroma.append(_upsample(small, H, W))
    return _ycc_to_bgr(y.astype(np.int64), *chroma)
