"""Builds a module from a configuration dict ``dict(type=..., **kwargs)``
by the class name, for the types the benchmark's configurations use."""


def build(cfg):
    from .batchloss_head import PointSegBatchlossHead
    from .fcn_mseg3d_head import FCNMSeg3DHead
    from .hrnet import HRNet
    from .mseg3d_head import PointSegMSeg3DHead
    from .segmentors import SegMSeg3DNet, SegNet
    from .unet_scn import UNetSCN3D
    from .voxel_encoders import (ImprovedMeanVoxelFeatureExtractor,
                                 MeanVoxelFeatureExtractor,
                                 TransformerVoxelFeatureExtractor)

    types = {c.__name__: c for c in (
        PointSegBatchlossHead, FCNMSeg3DHead, HRNet, PointSegMSeg3DHead,
        SegMSeg3DNet, SegNet, UNetSCN3D, ImprovedMeanVoxelFeatureExtractor,
        MeanVoxelFeatureExtractor, TransformerVoxelFeatureExtractor)}
    args = dict(cfg)
    kind = args.pop("type")
    if kind not in types:
        raise KeyError(f"the reference has no {kind!r}")
    return types[kind](**args)
