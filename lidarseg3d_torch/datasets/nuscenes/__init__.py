from . import metadata  # noqa: F401
from .common import create_nuscenes_seg_infos  # noqa: F401
from .dataset import SemanticNuscDataset  # noqa: F401
