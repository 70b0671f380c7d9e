"""Pipeline composition (own copy of
lidarseg3d_tpu/datasets/pipelines/compose.py)."""

from ...utils.registry import build_from_cfg
from ..registry import PIPELINES


class Compose:
    def __init__(self, transforms):
        self.transforms = []
        for t in transforms:
            if isinstance(t, dict):
                self.transforms.append(build_from_cfg(t, PIPELINES))
            elif callable(t):
                self.transforms.append(t)
            else:
                raise TypeError(
                    f"transform must be callable or dict, got {t!r}")

    def __call__(self, sample, info):
        for t in self.transforms:
            sample, info = t(sample, info)
            if sample is None:
                return None, None
        return sample, info
