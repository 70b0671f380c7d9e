"""nuScenes-lidarseg label metadata (own copy of
lidarseg3d_tpu/datasets/nuscenes/metadata.py: the public dataset
configuration): the 16 evaluated classes and the ignore class, the
learning map of the 32 raw lidarseg ids, its lookup table and the six
camera channels in the order camera ids 1-6 follow."""

import numpy as np

LABELS_16 = {
    0: "noise", 1: "barrier", 2: "bicycle", 3: "bus", 4: "car",
    5: "construction_vehicle", 6: "motorcycle", 7: "pedestrian",
    8: "traffic_cone", 9: "trailer", 10: "truck", 11: "driveable_surface",
    12: "other_flat", 13: "sidewalk", 14: "terrain", 15: "manmade",
    16: "vegetation",
}

LEARNING_MAP = {
    0: 0, 1: 0, 5: 0, 7: 0, 8: 0, 10: 0, 11: 0, 13: 0, 19: 0, 20: 0, 29: 0,
    31: 0, 9: 1, 14: 2, 15: 3, 16: 3, 17: 4, 18: 5, 21: 6, 2: 7, 3: 7, 4: 7,
    6: 7, 12: 8, 22: 9, 23: 10, 24: 11, 25: 12, 26: 13, 27: 14, 28: 15,
    30: 16,
}

NUM_CLASSES = 17  # incl. ignore class 0

REMAP_LUT = np.zeros(max(LEARNING_MAP) + 1, dtype=np.int32)
for raw, train in LEARNING_MAP.items():
    REMAP_LUT[raw] = train

CAM_CHANS = [
    "CAM_FRONT", "CAM_FRONT_RIGHT", "CAM_BACK_RIGHT", "CAM_BACK",
    "CAM_BACK_LEFT", "CAM_FRONT_LEFT",
]
