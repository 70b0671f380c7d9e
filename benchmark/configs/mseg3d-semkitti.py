# The benchmark's configuration mseg3d-semkitti: MSeg3D on SemanticKITTI,
# ImprovedMeanVFE + UNetSCN3D (r=2) + HRNet-w18 + FCN image head +
# multimodal fusion point head, as the repo's
# configs/semantickitti/MSeg3D/semkitti_avgvfe_unetscn3d_hrnetw18_lr1en2_e12.py
# holds the published experiment (jialeli1/lidarseg3d, CVPR 2023), with its
# padded capacities. One change (BENCHMARK.json "reduced"):
# hrnet_w18.pretrained is None, the benchmark drawing every weight from
# the run's seed (the ImageNet HRNet-w18 file is not on the machines).

num_class = 20
ignore_class = 0
point_cloud_range = [-75.2, -75.2, -4, 75.2, 75.2, 2]
voxel_size = [0.1, 0.1, 0.15]
ignore_label = ignore_class

use_img = True
cam_names = ["1"]
semkitti_mean = [0.406, 0.456, 0.485]  # BGR
semkitti_std = [0.225, 0.224, 0.229]
cam_attributes = {"1": dict(mean=semkitti_mean, std=semkitti_std)}
img_resized_shape = (1280, 384)  # (W, H)

hrnet_w18 = dict(
    type="HRNet",
    pretrained=None,
    frozen_stages=3,
    norm_eval=False,
    extra=dict(
        stage1=dict(num_modules=1, num_branches=1, block="BOTTLENECK",
                    num_blocks=(4,), num_channels=(64,)),
        stage2=dict(num_modules=1, num_branches=2, block="BASIC",
                    num_blocks=(4, 4), num_channels=(18, 36)),
        stage3=dict(num_modules=4, num_branches=3, block="BASIC",
                    num_blocks=(4, 4, 4), num_channels=(18, 36, 72)),
        stage4=dict(num_modules=3, num_branches=4, block="BASIC",
                    num_blocks=(4, 4, 4, 4), num_channels=(18, 36, 72, 144)),
    ),
)

fcn_head = dict(
    type="FCNMSeg3DHead",
    num_classes=num_class,
    ignore_index=ignore_class,
    in_index=(0, 1, 2, 3),
    in_channels=(18, 36, 72, 144),
    num_convs=2,
    channels=48,
    concat_input=False,
    loss_weight=0.5,
)
# TPU mixed precision (optional, off by default to match the reference
# fp32 recipe): bf16 activations through HRNet + FCN convs, fp32
# params/BN/outputs (tests/test_mseg3d.py::test_img_branch_bf16...):
#   hrnet_w18["compute_dtype"] = "bfloat16"
#   fcn_head["compute_dtype"] = "bfloat16"

model = dict(
    type="SegMSeg3DNet",
    pretrained=None,
    img_backbone=hrnet_w18 if use_img else None,
    img_head=fcn_head if use_img else None,
    reader=dict(type="ImprovedMeanVoxelFeatureExtractor", num_input_features=4),
    backbone=dict(
        type="UNetSCN3D", num_input_features=4 + 8, ds_factor=8, us_factor=8,
        point_cloud_range=point_cloud_range, voxel_size=voxel_size,
        model_cfg=dict(SCALING_RATIO=2, DOWN_CAPACITY_RATIOS=(0.5, 0.25, 0.15)),
    ),
    point_head=dict(
        type="PointSegMSeg3DHead",
        class_agnostic=False,
        num_class=num_class,
        model_cfg=dict(
            VOXEL_IN_DIM=32, VOXEL_CLS_FC=[64], VOXEL_ALIGN_DIM=64,
            IMAGE_IN_DIM=48, IMAGE_ALIGN_DIM=64, GEO_FUSED_DIM=64,
            OUT_CLS_FC=[64, 64], IGNORED_LABEL=ignore_class, DP_RATIO=0.25,
            MIMIC_FC=[64, 64],
            SFPhase_CFG=dict(
                embeddings_proj_kernel_size=1, d_model=96, n_head=4,
                n_layer=6, n_ffn=192, drop_ratio=0, activation="relu",
                pre_norm=False,
            ),
        ),
    ),
)

train_cfg = dict()
test_cfg = dict()

dataset_type = "SemanticKITTIDataset"
data_root = "data/SemanticKITTI/dataset/sequences"
nsweeps = 1

train_preprocessor = dict(
    mode="train", shuffle_points=True, npoints=500000,
    global_rot_noise=[-0.78539816, 0.78539816],
    global_scale_noise=[0.95, 1.05], global_translate_std=0.5,
)
val_preprocessor = dict(mode="val", shuffle_points=False)

train_img_preprocessor = dict(
    shuffle_points=True,
    random_horizon_flip=True,
    random_color_jitter_cfg=dict(brightness=0.3, contrast=0.3,
                                 saturation=0.3, hue=0.1),
    random_jpeg_compression_cfg=dict(quality_noise=[30, 70], probability=0.5),
)
val_img_preprocessor = dict(shuffle_points=False)

voxel_generator = dict(
    range=point_cloud_range, voxel_size=voxel_size,
    max_points_in_voxel=5, max_voxel_num=[160000, 160000],
)
capacity = dict(max_voxels=160000, max_points=131072)

train_pipeline = [
    dict(type="LoadPointCloudFromFile", dataset=dataset_type, use_img=use_img),
    dict(type="LoadImageFromFile", use_img=use_img),
    dict(type="LoadPointCloudAnnotations", with_bbox=False),
    dict(type="LoadImageAnnotations", points_cp_radius=2),
    dict(type="SegPreprocess", cfg=train_preprocessor),
    dict(type="SegImagePreprocess", cfg=train_img_preprocessor),
    dict(type="SegVoxelization", cfg=voxel_generator),
    dict(type="SegAssignLabel", cfg=dict(voxel_label_enc="compact_value")),
    dict(type="Reformat"),
]
val_pipeline = [
    dict(type="LoadPointCloudFromFile", dataset=dataset_type, use_img=use_img),
    dict(type="LoadImageFromFile", use_img=use_img),
    dict(type="SegPreprocess", cfg=val_preprocessor),
    dict(type="SegImagePreprocess", cfg=val_img_preprocessor),
    dict(type="SegVoxelization", cfg=voxel_generator),
    dict(type="Reformat"),
]

train_seq = ["00", "01", "02", "03", "04", "05", "06", "07", "09", "10"]
val_seq = ["08"]
test_seq = ["11", "12", "13", "14", "15", "16", "17", "18", "19", "20", "21"]

_ds_common = dict(
    type=dataset_type, root_path=data_root, nsweeps=nsweeps, use_img=use_img,
    cam_names=cam_names, cam_attributes=cam_attributes,
    img_resized_shape=img_resized_shape,
)
data = dict(
    samples_per_gpu=2,
    workers_per_gpu=6,
    train=dict(sequences=train_seq, load_interval=1, pipeline=train_pipeline,
               **_ds_common),
    val=dict(sequences=val_seq, test_mode=True, load_interval=1,
             pipeline=val_pipeline, **_ds_common),
    test=dict(sequences=test_seq, test_mode=True, pipeline=val_pipeline,
              **_ds_common),
)

optimizer_config = dict(grad_clip=dict(max_norm=35, norm_type=2))
optimizer = dict(type="adam", amsgrad=0.0, wd=0.01, fixed_wd=True,
                 moving_average=False)
lr_config = dict(type="one_cycle", lr_max=0.01, moms=[0.95, 0.85],
                 div_factor=10.0, pct_start=0.4)

checkpoint_config = dict(interval=1)
log_config = dict(interval=5)
total_epochs = 12
log_level = "INFO"
work_dir = "./work_dirs/semkitti_avgvfe_unetscn3d_hrnetw18_lr1en2_e12"
