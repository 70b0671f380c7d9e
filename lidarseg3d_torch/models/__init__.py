from .builder import (  # noqa: F401
    build_backbone, build_detector, build_head, build_img_backbone,
    build_img_head, build_neck, build_point_head, build_reader,
)
from .registry import (  # noqa: F401
    BACKBONES, DETECTORS, HEADS, IMG_BACKBONES, IMG_HEADS, NECKS,
    POINT_HEADS, READERS, ROI_HEAD, SECOND_STAGE,
)
# registration
from .readers import (dynamic_vfe, pillar_encoder,  # noqa: F401,E402
                      voxel_encoders)
from .backbones import (cylinder3d, polarnet_unet, scn_det,  # noqa: F401,E402
                        unet_scn)
from .necks import rpn  # noqa: F401,E402
from .bbox_heads import center_head  # noqa: F401,E402
from .img_backbones import hrnet, resnet  # noqa: F401,E402
from .img_heads import fcn_head, fcn_mseg3d_head, sc_conv  # noqa: F401,E402
from .point_heads import (  # noqa: F401,E402
    batchloss_head, mseg3d_head, polarnet_head)
from .second_stage import bev_extractor  # noqa: F401,E402
from .roi_heads import roi_head  # noqa: F401,E402
from .segmentors import (point_pillars, seg_mseg3d,  # noqa: F401,E402
                         seg_net, seg_polarnet, two_stage, voxelnet)
