from .builder import (  # noqa: F401
    build_backbone, build_detector, build_img_backbone, build_img_head,
    build_point_head, build_reader,
)
from .registry import (  # noqa: F401
    BACKBONES, DETECTORS, IMG_BACKBONES, IMG_HEADS, POINT_HEADS, READERS,
)
# registration
from .readers import voxel_encoders  # noqa: F401,E402
from .backbones import unet_scn  # noqa: F401,E402
from .img_backbones import hrnet  # noqa: F401,E402
from .img_heads import fcn_mseg3d_head  # noqa: F401,E402
from .point_heads import mseg3d_head  # noqa: F401,E402
from .segmentors import seg_mseg3d  # noqa: F401,E402
