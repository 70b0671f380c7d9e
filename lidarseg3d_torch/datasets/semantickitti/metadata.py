"""SemanticKITTI label metadata (own copy of
lidarseg3d_tpu/datasets/semantickitti/metadata.py: the public dataset
configuration of the semantic-kitti-api)."""

import numpy as np

LABELS = {
    0: "unlabeled", 1: "outlier", 10: "car", 11: "bicycle", 13: "bus",
    15: "motorcycle", 16: "on-rails", 18: "truck", 20: "other-vehicle",
    30: "person", 31: "bicyclist", 32: "motorcyclist", 40: "road",
    44: "parking", 48: "sidewalk", 49: "other-ground", 50: "building",
    51: "fence", 52: "other-structure", 60: "lane-marking", 70: "vegetation",
    71: "trunk", 72: "terrain", 80: "pole", 81: "traffic-sign",
    99: "other-object", 252: "moving-car", 253: "moving-bicyclist",
    254: "moving-person", 255: "moving-motorcyclist", 256: "moving-on-rails",
    257: "moving-bus", 258: "moving-truck", 259: "moving-other-vehicle",
}

LEARNING_MAP = {
    0: 0, 1: 0, 10: 1, 11: 2, 13: 5, 15: 3, 16: 5, 18: 4, 20: 5, 30: 6,
    31: 7, 32: 8, 40: 9, 44: 10, 48: 11, 49: 12, 50: 13, 51: 14, 52: 0,
    60: 9, 70: 15, 71: 16, 72: 17, 80: 18, 81: 19, 99: 0, 252: 1, 253: 7,
    254: 6, 255: 8, 256: 5, 257: 5, 258: 4, 259: 5,
}

LEARNING_MAP_INV = {
    0: 0, 1: 10, 2: 11, 3: 15, 4: 18, 5: 20, 6: 30, 7: 31, 8: 32, 9: 40,
    10: 44, 11: 48, 12: 49, 13: 50, 14: 51, 15: 70, 16: 71, 17: 72, 18: 80,
    19: 81,
}

THING_CLASS = {
    0: False, 1: True, 2: True, 3: True, 4: True, 5: True, 6: True, 7: True,
    8: True, 9: False, 10: False, 11: False, 12: False, 13: False, 14: False,
    15: False, 16: False, 17: False, 18: False, 19: False,
}

NUM_CLASSES = 20  # incl. ignore class 0

# dense remap array: raw label id -> train id
_max_raw = max(LEARNING_MAP) + 1
REMAP_LUT = np.zeros(_max_raw, dtype=np.int32)
for raw, train in LEARNING_MAP.items():
    REMAP_LUT[raw] = train

REMAP_LUT_INV = np.zeros(NUM_CLASSES, dtype=np.uint32)
for train, raw in LEARNING_MAP_INV.items():
    REMAP_LUT_INV[train] = raw


def class_names():
    """train-id -> human name, lowest raw id wins (matches
    get_SemKITTI_label_name iteration order, semantickitti.py:30-35)."""
    name = {}
    for raw in sorted(LEARNING_MAP, reverse=True):
        name[LEARNING_MAP[raw]] = LABELS[raw]
    return name
