"""Image transforms of the evaluation pipeline (own copy of the val-path
functions of lidarseg3d_tpu/datasets/pipelines/img_transforms.py), without
cv2.

``resize_image_points_label`` resizes as ``cv2.resize`` does, bit for bit:
bilinear on uint8 (INTER_LINEAR) in cv2's fixed point, and nearest
(INTER_NEAREST) for label maps. cv2's bilinear on 8-bit images weighs two
source columns with 11-bit integer coefficients (1 - f and f, each times
2048 and rounded half to even, f from ``(dx + 0.5) * scale - 0.5`` in
float32, clamped to the edge columns), then two of those rows with 11-bit
coefficients, ``((b0 * (r0 >> 4)) >> 16) + ((b1 * (r1 >> 4)) >> 16) + 2 >>
2``; ``scale`` is ``1 / (dsize / ssize)`` in double. The train
augmentations (flip, colour jitter, JPEG compression, rescale, crop) are
not ported yet.
"""

import numpy as np

_COEF_SCALE = 2048  # cv2's INTER_RESIZE_COEF_SCALE (11 bits)


def _source_taps(dsize, ssize):
    """cv2's source index and float32 fraction of each output position."""
    scale = 1.0 / (dsize / ssize)
    f = ((np.arange(dsize) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    return s, f - s.astype(np.float32)


def _coefs(f):
    one, scale = np.float32(1), np.float32(_COEF_SCALE)
    return (np.rint((one - f) * scale).astype(np.int64),
            np.rint(f * scale).astype(np.int64))


def resize_linear_u8(image, width, height):
    """uint8 [H, W, C] -> [height, width, C], as ``cv2.resize(image,
    (width, height), interpolation=cv2.INTER_LINEAR)``."""
    H0, W0 = image.shape[:2]
    sx, fx = _source_taps(width, W0)
    fx[(sx < 0) | (sx >= W0 - 1)] = 0  # edge columns: weight 1 on one
    sx = np.clip(sx, 0, W0 - 1)
    a0, a1 = _coefs(fx)
    sy, fy = _source_taps(height, H0)  # rows: clamped, weights kept
    b0, b1 = _coefs(fy)
    src = image.astype(np.int64)
    rows = (src[:, sx] * a0[None, :, None]
            + src[:, np.minimum(sx + 1, W0 - 1)] * a1[None, :, None]) >> 4
    r0 = rows[np.clip(sy, 0, H0 - 1)]
    r1 = rows[np.clip(sy + 1, 0, H0 - 1)]
    out = (((b0[:, None, None] * r0) >> 16)
           + ((b1[:, None, None] * r1) >> 16) + 2) >> 2
    return out.astype(np.uint8)


def resize_nearest(image, width, height):
    """[H, W, ...] -> [height, width, ...], as ``cv2.resize`` with
    INTER_NEAREST: source index floor(d * ssize / dsize), clamped."""
    H0, W0 = image.shape[:2]
    sx = np.minimum(np.floor(np.arange(width) * (1.0 / (width / W0)))
                    .astype(np.int64), W0 - 1)
    sy = np.minimum(np.floor(np.arange(height) * (1.0 / (height / H0)))
                    .astype(np.int64), H0 - 1)
    return image[sy[:, None], sx[None, :]]


def resize_image_points_label(image, points_cp, image_label, resized_shape):
    """resized_shape: (W, H) cv2 convention."""
    H0, W0 = image.shape[:2]
    W1, H1 = resized_shape
    img = resize_linear_u8(image, W1, H1)
    if points_cp is not None and len(points_cp):
        points_cp = points_cp.copy()
        points_cp[:, 1] *= W1 / W0
        points_cp[:, 2] *= H1 / H0
    if image_label is not None:
        image_label = resize_nearest(image_label, W1, H1)
    return img, points_cp, image_label


def normalize_image(image, mean, std):
    """BGR uint8 -> float32 normalized by per-channel mean/std (0-1 scale)."""
    img = image.astype(np.float32) / 255.0
    return (img - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


def normalize_image_into(image, mean, std, out):
    """normalize_image written straight into a preallocated fp32 slot, as
    (img/255 - mean)/std == img * (1/(255 std)) - mean/std in two in-place
    passes over ``out``."""
    scale = 1.0 / (255.0 * np.asarray(std, np.float32))
    bias = np.asarray(mean, np.float32) / np.asarray(std, np.float32)
    np.multiply(image, scale, out=out, casting="unsafe")
    np.subtract(out, bias, out=out)
    return out
