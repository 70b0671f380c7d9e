"""Datasets, pipelines and the loader of the port (counterparts of
lidarseg3d_tpu/datasets). Importing the package registers every pipeline
stage and dataset it holds."""

from .registry import DATASETS, PIPELINES  # noqa: F401
from .builder import build_dataset  # noqa: F401
from .pipelines import (compose, det_pipeline, instance_aug,  # noqa: F401
                        loading, seg_preprocess)
from .semantickitti import dataset as _semkitti  # noqa: F401
from .nuscenes import dataset as _nusc  # noqa: F401
from .waymo import dataset as _waymo  # noqa: F401
from .loader import (EpochSampler, SegDataLoader,  # noqa: F401
                     default_worker_mode)
from .batching import collate_segnet, pad_batch_rows  # noqa: F401
