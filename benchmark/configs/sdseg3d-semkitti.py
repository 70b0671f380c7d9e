# The benchmark's configuration sdseg3d-semkitti: SDSeg3D on SemanticKITTI,
# TransVFE + UNetSCN3D (r=2) + batch-loss point head, unchanged from the
# repo's configs/semantickitti/SDSeg3D/semkitti_transVFE_unetscn3d_batchloss_e10.py
# (jialeli1/lidarseg3d, ECCV 2022). Its _tta twin differs only in test_cfg
# and tta_cfg, which the traffic mix infer-tta carries.

num_class = 20
point_cloud_range = [-75.2, -75.2, -4, 75.2, 75.2, 2]
voxel_size = [0.1, 0.1, 0.15]
ignore_label = 0

model = dict(
    type="SegNet",
    pretrained=None,
    reader=dict(
        type="TransformerVoxelFeatureExtractor",
        num_input_features=4,
        num_compressed_features=16,
        num_embed=64,
        num_head=4,
        num_layers=3,
    ),
    backbone=dict(
        type="UNetSCN3D",
        num_input_features=16,
        ds_factor=8,
        us_factor=8,
        point_cloud_range=point_cloud_range,
        voxel_size=voxel_size,
        model_cfg=dict(
            SCALING_RATIO=2,
            DOWN_CAPACITY_RATIOS=(0.5, 0.25, 0.15),
        ),
    ),
    point_head=dict(
        type="PointSegBatchlossHead",
        class_agnostic=False,
        num_class=num_class,
        model_cfg=dict(
            CONV_IN_DIM=32,
            CONV_CLS_FC=[64],
            CONV_ALIGN_DIM=64,
            OUT_CLS_FC=[64, 64],
            IGNORED_LABEL=ignore_label,
        ),
    ),
)

train_cfg = dict()
test_cfg = dict()

dataset_type = "SemanticKITTIDataset"
data_root = "data/SemanticKITTI/dataset/sequences"
nsweeps = 1

train_preprocessor = dict(
    mode="train",
    shuffle_points=True,
    npoints=120000,
    global_rot_noise=[-0.78539816, 0.78539816],
    global_scale_noise=[0.95, 1.05],
    global_translate_std=0.5,
)
val_preprocessor = dict(mode="val", shuffle_points=False)

voxel_generator = dict(
    range=point_cloud_range,
    voxel_size=voxel_size,
    max_points_in_voxel=5,
    max_voxel_num=[160000, 160000],
)

# static per-frame padding capacities (TPU-specific)
capacity = dict(max_voxels=160000, max_points=131072)

train_pipeline = [
    dict(type="LoadPointCloudFromFile", dataset=dataset_type),
    dict(type="LoadPointCloudAnnotations", with_bbox=False),
    dict(type="SegPreprocess", cfg=train_preprocessor),
    dict(type="SegVoxelization", cfg=voxel_generator),
    dict(type="SegAssignLabel", cfg=dict(voxel_label_enc="compact_value")),
    dict(type="Reformat"),
]
val_pipeline = [
    dict(type="LoadPointCloudFromFile", dataset=dataset_type),
    dict(type="SegPreprocess", cfg=val_preprocessor),
    dict(type="SegVoxelization", cfg=voxel_generator),
    dict(type="Reformat"),
]

train_seq = ["00", "01", "02", "03", "04", "05", "06", "07", "09", "10"]
val_seq = ["08"]
test_seq = ["11", "12", "13", "14", "15", "16", "17", "18", "19", "20", "21"]

data = dict(
    samples_per_gpu=4,
    workers_per_gpu=6,
    train=dict(
        type=dataset_type, root_path=data_root, sequences=train_seq,
        nsweeps=nsweeps, load_interval=1, pipeline=train_pipeline,
    ),
    val=dict(
        type=dataset_type, root_path=data_root, sequences=val_seq,
        test_mode=True, nsweeps=nsweeps, load_interval=1,
        pipeline=val_pipeline,
    ),
    test=dict(
        type=dataset_type, root_path=data_root, sequences=test_seq,
        test_mode=True, nsweeps=nsweeps, pipeline=val_pipeline,
    ),
)

optimizer_config = dict(grad_clip=dict(max_norm=35, norm_type=2))
optimizer = dict(type="adam", amsgrad=0.0, wd=0.01, fixed_wd=True,
                 moving_average=False)
lr_config = dict(type="one_cycle", lr_max=0.001, moms=[0.95, 0.85],
                 div_factor=10.0, pct_start=0.4)

checkpoint_config = dict(interval=1)
log_config = dict(interval=5)

total_epochs = 10
log_level = "INFO"
work_dir = "./work_dirs/semkitti_transVFE_unetscn3d_batchloss_e10"
load_from = None
resume_from = None
workflow = [("train", 1)]
