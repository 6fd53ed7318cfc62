"""Training-time augmentations on range-image frames: the port's own numpy
copy of ``rangedet_tpu/data/augment.py`` (the port imports nothing of the JAX
package).

Two geometric augmentations as host-side numpy ops on the raw frame dict
(before normalization/stacking); both remap the range image columns so the
projective structure stays consistent. The reference defines them but ships
them disabled (config/rangedet/...:223-239,351-352); the multiclass recipe
turns them on.

``cfg.augment`` (e.g. ``("flip", "rotation")``) selects them by name; the
loader hook is data/waymo.py:record_to_inputs -> apply_augmentations. The
random draws, their order and every array operation are the reference's, so
a seeded generator gives bit-equal frames.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

# image-space channels that remap with the columns (flip / roll). is_in_nlz
# rides along so NLZ exclusion stays pixel-aligned after augmentation.
_IMAGE_KEYS = ("range_value", "intensity", "elongation", "mask",
               "inclination", "is_in_nlz")

AUGMENTATIONS = {}


def _register(name):
    def deco(fn):
        AUGMENTATIONS[name] = fn
        return fn
    return deco


@_register("flip")
def world_flip(frame: Dict[str, np.ndarray], rng: np.random.RandomState,
               prob: float = 0.5) -> Dict[str, np.ndarray]:
    """Mirror the world across the x-z plane (y -> -y).

    In the range image this is a left-right column flip (azimuth -> -azimuth);
    GT boxes flip cy and yaw. One ``uniform()`` draw; at or above ``prob`` the
    frame is returned as it came.
    """
    if rng.uniform() >= prob:
        return frame
    out = dict(frame)
    for k in _IMAGE_KEYS:
        if k in out:
            # a copy: inclination arrives as a read-only broadcast view
            out[k] = out[k][:, ::-1].copy()
    pc = frame["pc"][:, ::-1].copy()
    pc[..., 1] = -pc[..., 1]
    out["pc"] = pc
    out["azimuth"] = np.arctan2(pc[..., 1], pc[..., 0]).astype(np.float32)
    gt = frame["gt_csa"].copy()
    gt[:, 1] = -gt[:, 1]
    gt[:, 6] = -gt[:, 6]
    out["gt_csa"] = gt
    return out


@_register("rotation")
def world_rotation(frame: Dict[str, np.ndarray], rng: np.random.RandomState,
                   interval=(-np.pi / 4, np.pi / 4)) -> Dict[str, np.ndarray]:
    """Rotate the world about z by a random angle.

    A z-rotation is a *circular column shift* of the range image (azimuth
    offset), so all image-space channels roll; points and boxes rotate. One
    ``uniform(*interval)`` draw, quantized to whole columns. The yaw is left
    unwrapped (``yaw + theta``), and the azimuth is recomputed from the
    rotated points (0 at holes, where the point is 0).
    """
    theta = float(rng.uniform(*interval))
    W = frame["mask"].shape[1]
    shift = int(round(theta / (2 * np.pi) * W))
    theta = shift * 2 * np.pi / W  # quantize so image and geometry agree

    out = dict(frame)
    # columns scan azimuth from +pi to -pi: +theta rotation shifts right
    for k in _IMAGE_KEYS:
        if k in out:
            out[k] = np.roll(out[k], shift, axis=1)
    c, s = np.cos(theta), np.sin(theta)
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    pc = np.roll(frame["pc"], shift, axis=1) @ rot.T
    out["pc"] = pc.astype(np.float32)
    out["azimuth"] = np.arctan2(pc[..., 1], pc[..., 0]).astype(np.float32)
    gt = frame["gt_csa"].copy()
    gt[:, :3] = gt[:, :3] @ rot.T
    gt[:, 6] = gt[:, 6] + theta
    out["gt_csa"] = gt
    return out


def apply_augmentations(frame: Dict[str, np.ndarray],
                        rng: "np.random.RandomState",
                        names) -> Dict[str, np.ndarray]:
    """Apply cfg.augment's named augmentations in order ("flip",
    "rotation"). The loader hook: record_to_inputs calls this on the raw
    frame dict before normalization/stacking (the stage where the
    reference's transform list would run them, config:223-239)."""
    for n in names:
        frame = AUGMENTATIONS[n](frame, rng)
    return frame
