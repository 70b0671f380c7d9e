"""8-bit BGR <-> HSV conversions in numpy, as ``cv2.cvtColor`` does them
with ``COLOR_BGR2HSV`` and ``COLOR_HSV2BGR`` (H in [0, 180)), for machines
without cv2.

BGR -> HSV is cv2's integer arithmetic: V = max(B, G, R), diff = V -
min(B, G, R), S = (diff * sdiv[V] + 2^11) >> 12 with sdiv[i] =
round(255 * 2^12 / i), and H from the channel that holds the maximum
(R first, then G) as (h * hdiv[diff] + 2^11) >> 12 with hdiv[i] =
round(180 * 2^12 / (6 i)), plus 180 when negative.

HSV -> BGR is cv2's float32 arithmetic: h * (6 / 180) gives the sector
(its integer part) and the fraction f, S and V are scaled by 1 / 255, the
three channels are picked from v, v (1 - s), v (1 - s f) and
v (1 - s (1 - f)) by sector (1 - s f and 1 - s (1 - f) each one fused
multiply-add), and each is multiplied by 255. cv2 (its AVX2 build) converts
each image row in blocks of 32 pixels whose values it truncates, and the
row's last ``W % 32`` pixels one at a time, rounding half to even; this
module does the same.
"""

import numpy as np

_SHIFT = 12
_i = np.arange(1, 256, dtype=np.float64)
_SDIV = np.concatenate([[0], np.rint((255 << _SHIFT) / _i)]).astype(np.int64)
_HDIV = np.concatenate([[0], np.rint((180 << _SHIFT) / (6.0 * _i))]).astype(
    np.int64)
del _i
_BLOCK = 32  # pixels of one vector step of cv2's AVX2 HSV -> BGR
# (b, g, r) <- tab[...] by sector: tab = (v, v(1-s), v(1-sf), v(1-s(1-f)))
_SECTOR_TAB = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1],
                        [0, 1, 3], [2, 1, 0]])


def bgr_to_hsv(image):
    """uint8 BGR [..., 3] -> uint8 HSV [..., 3], H in [0, 180)."""
    bgr = image.astype(np.int64)
    b, g, r = bgr[..., 0], bgr[..., 1], bgr[..., 2]
    v = np.maximum(np.maximum(b, g), r)
    diff = v - np.minimum(np.minimum(b, g), r)
    s = (diff * _SDIV[v] + (1 << (_SHIFT - 1))) >> _SHIFT
    h = np.where(v == r, g - b,
                 np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV[diff] + (1 << (_SHIFT - 1))) >> _SHIFT
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], -1).astype(np.uint8)


def _fms(a, b):
    """float32 1 - a * b with one rounding (a fused multiply-add)."""
    return (1.0 - a.astype(np.float64) * b).astype(np.float32)


def hsv_to_bgr(image):
    """uint8 HSV [H, W, 3] (H in [0, 180)) -> uint8 BGR [H, W, 3]."""
    hsv = image.astype(np.float32)
    h = hsv[..., 0] * np.float32(6.0 / 180.0)
    s = hsv[..., 1] * np.float32(1.0 / 255.0)
    v = hsv[..., 2] * np.float32(1.0 / 255.0)
    sector = np.floor(h)
    f = h - sector
    tab = np.stack([v, v * (np.float32(1.0) - s), v * _fms(s, f),
                    v * _fms(s, np.float32(1.0) - f)], -1)
    pick = _SECTOR_TAB[sector.astype(np.int64) % 6]
    bgr = np.take_along_axis(tab, pick, -1) * np.float32(255.0)
    body = image.shape[1] - image.shape[1] % _BLOCK
    out = np.empty(bgr.shape, np.float32)
    np.trunc(bgr[:, :body], out=out[:, :body])
    np.rint(bgr[:, body:], out=out[:, body:])
    return np.clip(out, 0, 255).astype(np.uint8)
