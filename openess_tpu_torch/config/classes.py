"""Class metadata for DDD17-Seg (6), DSEC-Semantic (11/19).

Reference: config/settings.py:121-175 (names, ignore label, color maps).
"""
from __future__ import annotations

import numpy as np

IGNORE_LABEL = 255

CLASS_NAMES = {
    6: ["flat", "background", "object", "vegetation", "human", "vehicle"],
    11: [
        "background", "building", "fence", "person", "pole", "road",
        "sidewalk", "vegetation", "car", "wall", "traffic sign",
    ],
    19: [
        "road", "sidewalk", "building", "wall", "fence",
        "pole", "traffic light", "traffic sign",
        "vegetation", "terrain", "sky",
        "person", "rider",
        "car", "truck", "bus", "train", "motorcycle", "bicycle",
    ],
}

COLOR_MAPS = {
    6: np.array(
        [
            [128, 64, 128], [70, 70, 70], [220, 220, 0],
            [107, 142, 35], [220, 20, 60], [0, 0, 142],
        ],
        np.uint8,
    ),
    11: np.array(
        [
            [0, 150, 255], [118, 118, 118], [214, 220, 229], [4, 50, 255],
            [190, 153, 153], [155, 55, 255], [102, 102, 156], [0, 176, 80],
            [250, 188, 1], [152, 251, 152], [255, 0, 0],
        ],
        np.uint8,
    ),
    19: np.array(
        [
            [0, 0, 0], [70, 70, 70], [190, 153, 153], [220, 20, 60],
            [153, 153, 153], [128, 64, 128], [244, 35, 232], [107, 142, 35],
            [0, 0, 142], [102, 102, 156], [220, 220, 0], [0, 0, 0],
            [0, 0, 0], [0, 0, 0], [0, 0, 0], [0, 0, 0], [0, 0, 0],
            [0, 0, 0], [0, 0, 0],
        ],
        np.uint8,
    ),
}
