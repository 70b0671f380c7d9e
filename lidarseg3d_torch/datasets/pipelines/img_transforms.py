"""Image transforms co-applied to the points' pixel coordinates and the
pixel labels (own copy of lidarseg3d_tpu/datasets/pipelines/
img_transforms.py), without cv2.

``resize_image_points_label`` resizes as ``cv2.resize`` does, bit for bit:
bilinear on uint8 (INTER_LINEAR) in cv2's fixed point, and nearest
(INTER_NEAREST) for label maps. cv2's bilinear on 8-bit images weighs two
source columns with 11-bit integer coefficients (1 - f and f, each times
2048 and rounded half to even, f from ``(dx + 0.5) * scale - 0.5`` in
float32, clamped to the edge columns), then two of those rows with 11-bit
coefficients, ``((b0 * (r0 >> 4)) >> 16) + ((b1 * (r1 >> 4)) >> 16) + 2 >>
2``; ``scale`` is ``1 / (dsize / ssize)`` in double.

The train augmentations (horizontal flip, colour jitter, JPEG
compression, rescale, crop) draw from the ``rng`` they are given in the
JAX package's order and number, a branch that does not fire included.
The colour jitter's HSV conversions are colorspace.py's, the JPEG round
trip jpeg.py's, both cv2's arithmetic in numpy. points_cp rows are
[cam_id, w_coord, h_coord].
"""

import numpy as np

from .colorspace import bgr_to_hsv, hsv_to_bgr
from .jpeg import jpeg_round_trip

_COEF_SCALE = 2048  # cv2's INTER_RESIZE_COEF_SCALE (11 bits)


def _source_taps(dsize, ssize):
    """cv2's source index and float32 fraction of each output position."""
    scale = 1.0 / (dsize / ssize)
    f = ((np.arange(dsize) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    return s, f - s.astype(np.float32)


def _coefs(f):
    # int32 holds every product: 255 * 2048 >> 4 times 2048
    one, scale = np.float32(1), np.float32(_COEF_SCALE)
    return (np.rint((one - f) * scale).astype(np.int32),
            np.rint(f * scale).astype(np.int32))


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
    src = image.astype(np.int32)
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


def random_horizontal_flip(image, points_cp_w, image_label, rng,
                           probability=0.5):
    """Flips the width axis; points_cp_w are the w coords of this cam."""
    if rng.random() < probability:
        W = image.shape[1]
        image = image[:, ::-1].copy()
        points_cp_w = W - 1 - points_cp_w
        if image_label is not None:
            image_label = image_label[:, ::-1].copy()
    return image, points_cp_w, image_label


def color_jitter(image, rng, brightness=0.3, contrast=0.3, saturation=0.3,
                 hue=0.1):
    """torchvision-style ColorJitter on a BGR uint8 image."""
    img = image.astype(np.float32)
    if brightness:
        img *= rng.uniform(max(0, 1 - brightness), 1 + brightness)
    if contrast:
        f = rng.uniform(max(0, 1 - contrast), 1 + contrast)
        # torchvision uses the grayscale mean
        gray = (0.114 * img[..., 0] + 0.587 * img[..., 1]
                + 0.299 * img[..., 2]).mean()
        img = f * img + (1 - f) * gray
    img = np.clip(img, 0, 255).astype(np.uint8)
    if saturation or hue:
        hsv = bgr_to_hsv(img).astype(np.float32)
        if saturation:
            hsv[..., 1] *= rng.uniform(max(0, 1 - saturation),
                                       1 + saturation)
        if hue:
            hsv[..., 0] = (hsv[..., 0] + rng.uniform(-hue, hue) * 180) % 180
        hsv[..., 1:] = np.clip(hsv[..., 1:], 0, 255)
        img = hsv_to_bgr(hsv.astype(np.uint8))
    return img


def jpeg_compression(image, rng, quality_noise=(30, 70), probability=0.5):
    if rng.random() < probability:
        q = int(rng.uniform(quality_noise[0], quality_noise[1]))
        image = jpeg_round_trip(image, q)
    return image


def random_rescale(image, points_cp, image_label, rng, scale_noise=(1.0, 1.5),
                   probability=0.5):
    if rng.random() < probability:
        s = rng.uniform(scale_noise[0], scale_noise[1])
        H0, W0 = image.shape[:2]
        image, points_cp, image_label = resize_image_points_label(
            image, points_cp, image_label, (int(W0 * s), int(H0 * s)))
    return image, points_cp, image_label


def random_crop(image, points_cp, image_label, rng, crop_shape=(320, 1024)):
    """crop_shape: (H, W). Points falling outside get cam_id = -1."""
    H0, W0 = image.shape[:2]
    ch, cw = min(crop_shape[0], H0), min(crop_shape[1], W0)
    y0 = rng.integers(0, H0 - ch + 1)
    x0 = rng.integers(0, W0 - cw + 1)
    image = image[y0:y0 + ch, x0:x0 + cw]
    if image_label is not None:
        image_label = image_label[y0:y0 + ch, x0:x0 + cw]
    if points_cp is not None and len(points_cp):
        points_cp = points_cp.copy()
        points_cp[:, 1] -= x0
        points_cp[:, 2] -= y0
        inside = ((points_cp[:, 1] >= 0) & (points_cp[:, 1] <= cw - 1)
                  & (points_cp[:, 2] >= 0) & (points_cp[:, 2] <= ch - 1))
        points_cp[~inside, 0] = -1
    return image, points_cp, image_label


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
