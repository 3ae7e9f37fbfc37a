"""COCO-panoptic class vocabulary + display palette.

The reference imports `COCO_PANOPTIC_CLASSES/COLORS` from its (absent) kmax
package and strips "-other"/"-merged" suffixes (handy_utils.py:22-26). The
class list below is the standard public COCO panoptic vocabulary in the
contiguous 0..132 category-id order (80 things then 53 stuff). Display colors
are a deterministic golden-ratio HSV palette (the reference's exact RGB
values live in detectron2 metadata and only affect visualization).
"""
from __future__ import annotations

import colorsys

import numpy as np

NULL_CLASS_ID = 133  # reference: null voxels get class 133 (handy_utils.py:112)
NUM_CLASSES_WITH_SPARE = 143  # 133 + 10 spare (clip_seem_fusion.py:655-659)

_THINGS = [
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train",
    "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep", "cow",
    "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella", "handbag",
    "tie", "suitcase", "frisbee", "skis", "snowboard", "sports ball", "kite",
    "baseball bat", "baseball glove", "skateboard", "surfboard",
    "tennis racket", "bottle", "wine glass", "cup", "fork", "knife", "spoon",
    "bowl", "banana", "apple", "sandwich", "orange", "broccoli", "carrot",
    "hot dog", "pizza", "donut", "cake", "chair", "couch", "potted plant",
    "bed", "dining table", "toilet", "tv", "laptop", "mouse", "remote",
    "keyboard", "cell phone", "microwave", "oven", "toaster", "sink",
    "refrigerator", "book", "clock", "vase", "scissors", "teddy bear",
    "hair drier", "toothbrush",
]

_STUFF = [
    "banner", "blanket", "bridge", "cardboard", "counter", "curtain",
    "door-stuff", "floor-wood", "flower", "fruit", "gravel", "house",
    "light", "mirror-stuff", "net", "pillow", "platform", "playingfield",
    "railroad", "river", "road", "roof", "sand", "sea", "shelf", "snow",
    "stairs", "tent", "towel", "wall-brick", "wall-stone", "wall-tile",
    "wall-wood", "water-other", "window-blind", "window-other",
    "tree-merged", "fence-merged", "ceiling-merged", "sky-other-merged",
    "cabinet-merged", "table-merged", "floor-other-merged",
    "pavement-merged", "mountain-merged", "grass-merged", "dirt-merged",
    "paper-merged", "food-other-merged", "building-other-merged",
    "rock-merged", "wall-other-merged", "rug-merged",
]

COCO_PANOPTIC_CLASSES = _THINGS + _STUFF
assert len(COCO_PANOPTIC_CLASSES) == 133

# display-name normalization, exactly as the reference does
# (handy_utils.py:23-25), + "others" for the null class (133) + names for
# the 9 spare class slots the label histogram reserves (134..142; the
# reference reserves the space but never names it, clip_seem_fusion.py:655)
PREDEFINED_CLASSES = (
    [
        n.replace("-other", "").replace("-merged", "")
        for n in COCO_PANOPTIC_CLASSES
    ]
    + ["others"]
    + [f"object-{i}" for i in range(1, 10)]
)


def _palette(n: int) -> np.ndarray:
    cols = []
    for i in range(n):
        h = (i * 0.61803398875) % 1.0
        s = 0.65 + 0.35 * ((i * 7) % 3) / 2.0
        v = 0.75 + 0.25 * ((i * 5) % 2)
        cols.append([int(round(255 * c)) for c in colorsys.hsv_to_rgb(h, s, v)])
    return np.array(cols, np.int32)


# color per class id, + black for the null/"others" class, + colors for the
# spare object slots
PREDEFINED_COLORS = np.concatenate(
    [_palette(133), np.zeros((1, 3), np.int32), _palette(9)[::-1]], axis=0
)
assert len(PREDEFINED_CLASSES) == len(PREDEFINED_COLORS) == 143
