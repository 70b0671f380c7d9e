from .builder import (  # noqa: F401
    build_backbone, build_detector, build_img_backbone, build_img_head,
    build_point_head, build_reader,
)
from .registry import (  # noqa: F401
    BACKBONES, DETECTORS, IMG_BACKBONES, IMG_HEADS, POINT_HEADS, READERS,
)
# registration
from .readers import dynamic_vfe, voxel_encoders  # noqa: F401,E402
from .backbones import cylinder3d, polarnet_unet, unet_scn  # noqa: F401,E402
from .img_backbones import hrnet, resnet  # noqa: F401,E402
from .img_heads import fcn_head, fcn_mseg3d_head, sc_conv  # noqa: F401,E402
from .point_heads import (  # noqa: F401,E402
    batchloss_head, mseg3d_head, polarnet_head)
from .segmentors import seg_mseg3d, seg_net, seg_polarnet  # noqa: F401,E402
