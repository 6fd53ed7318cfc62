"""Input channel clipping + whitening constants (dataset statistics) — the
reference's ClipDataParam / NormDataParam
(config/rangedet/rangedet_veh_wo_aug_4_18e.py:245-267), shared by all recipes.
Values are (min, max) clips and (mean, variance) whitening stats over WOD.
"""
import numpy as np

CLIP = {
    "range_value": (0.0, 80.0),
    "intensity": (0.0, 1.0),
    "elongation": (0.0, 1.0),
    "x": (-80.0, 80.0),
    "y": (-80.0, 80.0),
    "z": (-5.0, 10.0),
    "inclination": (-0.5, 0.1),
    # azimuth is not clipped (SepAndClipData pops it, input.py:149)
}

NORM = {
    "range_value": (20.0, 1500.0),
    "intensity": (0.1, 0.01),
    "elongation": (7.2558375e-02, 2.6764875e-02),
    "x": (1.5672500e00, 3.0740625e02),
    "y": (9.8824875e-01, 2.1913250e02),
    "z": (1.4, 1.0),
    "inclination": (-8.8427375e-02, 9.9001750e-03),
    "azimuth": (-7.8061250e-03, 2.5494125e00),
}

# 8-channel input stack order (CombineDataParam, config:269-282)
CHANNELS = (
    "range_value", "intensity", "elongation", "x", "y", "z",
    "inclination", "azimuth",
)


def clip_and_norm(name: str, v: np.ndarray) -> np.ndarray:
    if name in CLIP:
        lo, hi = CLIP[name]
        v = np.clip(v, lo, hi)
    mean, var = NORM[name]
    return (v - mean) / np.sqrt(var)
