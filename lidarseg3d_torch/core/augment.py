"""Host-side point cloud augmentations of segmentation training (own copy
of lidarseg3d_tpu/core/augment.py).

Each draws from an explicit ``numpy.random.Generator`` in the JAX
package's order and number of draws, so both packages augment a frame
alike from the same seed.
"""

import numpy as np


def _rng(rng):
    return rng if rng is not None else np.random.default_rng()


def rotation_points_single_angle(points_xyz, angle, axis=2):
    s, c = np.sin(angle), np.cos(angle)
    if axis == 2 or axis == -1:
        rot_mat_T = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]],
                             dtype=points_xyz.dtype)
    elif axis == 1:
        rot_mat_T = np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]],
                             dtype=points_xyz.dtype)
    elif axis == 0:
        rot_mat_T = np.array([[1, 0, 0], [0, c, -s], [0, s, c]],
                             dtype=points_xyz.dtype)
    else:
        raise ValueError("axis should be in range")
    return points_xyz @ rot_mat_T


def points_random_flip(points, probability=0.5, rng=None):
    rng = _rng(rng)
    if rng.random() < probability:  # x flip (negate y)
        points[:, 1] = -points[:, 1]
    if rng.random() < probability:  # y flip (negate x)
        points[:, 0] = -points[:, 0]
    return points


def points_global_rotation(points, rotation=np.pi / 4, rng=None):
    rng = _rng(rng)
    if not isinstance(rotation, (list, tuple)):
        rotation = [-rotation, rotation]
    noise_rotation = rng.uniform(rotation[0], rotation[1])
    points[:, :3] = rotation_points_single_angle(points[:, :3],
                                                 noise_rotation, axis=2)
    return points


def points_global_scaling(points, min_scale=0.95, max_scale=1.05, rng=None):
    rng = _rng(rng)
    points[:, :3] *= rng.uniform(min_scale, max_scale)
    return points


def points_global_translate(points, noise_translate_std, rng=None):
    rng = _rng(rng)
    if not isinstance(noise_translate_std, (list, tuple, np.ndarray)):
        noise_translate_std = np.array([noise_translate_std] * 3)
    if all(e == 0 for e in noise_translate_std):
        return points
    noise = np.array([rng.normal(0, noise_translate_std[0]),
                      rng.normal(0, noise_translate_std[1]),
                      rng.normal(0, noise_translate_std[2])],
                     dtype=points.dtype)
    points[:, :3] += noise[None, :]
    return points


def points_random_jitter(points, probability=0.5, sigma=0.01, clip=0.05,
                         rng=None):
    rng = _rng(rng)
    if rng.random() < probability:
        noise = np.clip(sigma * rng.standard_normal((points.shape[0], 3)),
                        -clip, clip)
        points[:, 0:3] += noise.astype(points.dtype)
    return points
