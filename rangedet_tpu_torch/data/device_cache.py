"""Packed frame cache on the card and on-device augmentation: the port's
copy of ``rangedet_tpu/data/device_cache.py`` (the port imports nothing of
the JAX package).

A frame's raw fields are packed on the host into ~1.9 MB (u16 / i16 / u8
quantization) against ~11.6 MB for the full f32 training-batch dict
(``data/waymo.py:record_to_inputs``); the whole packed dataset is staged on
the card once, and every step rebuilds its batch there from the indices
alone: gather -> ``unpack_raw`` -> ``augment_raw`` (optional) ->
``finalize_inputs``. Only the index vector crosses to the card.

Quantization error budget:
  pc        i16, 1/409.5 m    -> 2.4 mm absolute, uniform over +-80 m
  range     u16, 80/65535 m   -> 0.6 mm
  intensity u8 over clip [0,1]-> 0.004 (0.04 sigma of the whitening stats)
  elongation u8 over clip     -> 0.004
  azimuth   recomputed from the quantized pc: <1e-3 rad at r >= 1 m
GT boxes and classes stay f32 (GT coordinates are never rounded).

``pack_inputs`` and ``stack_packed`` are numpy on the host; the rest are
torch functions on the packed tensors' device. ``range_q`` is u16 in the
packed numpy dict; ``to_device`` stages it as its int16 view (2 bytes a
pixel, as packed): torch's index_select has no uint16 kernel on the CPU,
and ``unpack_raw`` widens the gathered view with ``& 0xFFFF``.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .normalization import CHANNELS, CLIP, NORM

PC_SCALE = 409.5          # i16 per meter (+-80 m fits +-32760)
RANGE_SCALE = 65535.0 / 80.0

# flag bits of the u8 flags plane
_BIT_MASK = 1      # valid return (mask == 1)
_BIT_NLZ = 2       # is_in_nlz > 0
_BIT_ZERO = 4      # mask-0 pixel whose filled range is 0 (car window); the
#                    other mask-0 real pixels carry background fill 80

PACKED_KEYS = ("pc_q", "range_q", "intensity_q", "elongation_q", "flags",
               "inclination", "gt_csa", "gt_class", "gt_valid")


def pack_inputs(full: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Pack ONE record_to_inputs output dict (unbatched, padded) into the
    compact transfer form. ``full`` must carry the full-range channel in
    input_data (channel 0) so mask-0 pixels' 0-vs-80 fill is recoverable."""
    mask = full["mask"][..., 0] > 0.5
    nlz = full["is_in_nlz"][..., 0] > 0.0

    # un-whiten channel 0 to recover the pre-normalization clipped range for
    # every pixel (input_data keeps range 80/0 fills where mask == 0)
    mean, var = NORM["range_value"]
    rng_full = full["input_data"][..., 0] * np.sqrt(var) + mean
    rng_full = np.clip(rng_full, 0.0, 80.0)
    zero_fill = (~mask) & (rng_full < 40.0)  # mask-0 pixels: 0 or 80 fill

    # un-whiten intensity / elongation (clipped to [0,1] on the way in, so
    # u8 over the clip interval is lossless to 1/255)
    def unwhiten(name, ch):
        m, v = NORM[name]
        lo, hi = CLIP[name]
        return np.clip(full["input_data"][..., ch] * np.sqrt(v) + m, lo, hi)

    intensity = unwhiten("intensity", 1)
    elongation = unwhiten("elongation", 2)

    flags = (
        mask.astype(np.uint8) * _BIT_MASK
        + nlz.astype(np.uint8) * _BIT_NLZ
        + zero_fill.astype(np.uint8) * _BIT_ZERO
    )
    # inclination per row (channel 6 is constant across a row by
    # construction); un-whiten from column 0
    m_i, v_i = NORM["inclination"]
    incl_row = full["input_data"][:, :, 6] * np.sqrt(v_i) + m_i
    inclination = incl_row[:, 0].astype(np.float32)  # (H,)

    return dict(
        pc_q=np.round(
            full["pc"].transpose(2, 0, 1) * PC_SCALE
        ).astype(np.int16),                                   # (3, H, Wp)
        range_q=np.round(rng_full * RANGE_SCALE).astype(np.uint16),
        intensity_q=np.round(intensity * 255.0).astype(np.uint8),
        elongation_q=np.round(elongation * 255.0).astype(np.uint8),
        flags=flags,
        inclination=inclination,
        gt_csa=full["gt_csa"].astype(np.float32),
        gt_class=full["gt_class"].astype(np.float32),
        gt_valid=full["gt_valid"].astype(np.float32),
    )


def stack_packed(frames) -> Dict[str, np.ndarray]:
    """Stack per-frame packed dicts into one arrays-of-all-frames dict
    (the cache layout; frame axis leading on every field)."""
    return {k: np.stack([f[k] for f in frames]) for k in frames[0]}


def to_device(packed: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """The packed numpy dict as tensors on ``device``, bytes unchanged:
    ``range_q`` (u16) as its int16 view."""
    return {k: torch.from_numpy(np.ascontiguousarray(
                v.view(np.int16) if v.dtype == np.uint16 else v)).to(device)
            for k, v in packed.items()}


def gather_packed(cache: Dict[str, torch.Tensor], idx: torch.Tensor
                  ) -> Dict[str, torch.Tensor]:
    """Select a minibatch (on the cache's device) from the stacked packed
    cache; ``idx`` is an integer tensor on the same device."""
    return {k: v.index_select(0, idx) for k, v in cache.items()}


def _norm(name, v):
    if name in CLIP:
        lo, hi = CLIP[name]
        v = v.clamp(lo, hi)
    mean, var = NORM[name]
    return (v - mean) / float(np.sqrt(var))


def unpack_raw(packed: Dict[str, torch.Tensor], valid_w: int
               ) -> Dict[str, torch.Tensor]:
    """Dequantize a BATCHED packed dict to the raw per-pixel fields.
    Padded pixels (columns from ``valid_w`` on) are forced to exact
    zeros, matching record_to_inputs' zero padding."""
    flags = packed["flags"]
    B, H, Wp = flags.shape
    dev = flags.device
    col_ok = (torch.arange(Wp, device=dev) < valid_w)[None, None, :]

    mask = ((flags & _BIT_MASK) > 0) & col_ok
    nlz_bit = (flags & _BIT_NLZ) > 0
    zero_bit = (flags & _BIT_ZERO) > 0

    pc = packed["pc_q"].float().permute(0, 2, 3, 1) / PC_SCALE
    pc = torch.where(col_ok[..., None], pc, 0.0)
    # range_q: u16 bits in an int16 tensor (to_device), or a uint16 tensor
    rng = (packed["range_q"].to(torch.int32) & 0xFFFF).float() / RANGE_SCALE
    # mask-0 pixels: car-window fill 0 or background fill 80
    rng = torch.where(mask, rng, torch.where(zero_bit, 0.0, 80.0))
    rng = torch.where(col_ok, rng, 0.0)
    out = dict(
        range_value=rng,
        intensity=packed["intensity_q"].float() / 255.0,
        elongation=packed["elongation_q"].float() / 255.0,
        pc=pc,
        mask=mask,
        is_in_nlz=torch.where(nlz_bit, 1.0, -1.0),
        inclination=packed["inclination"][:, :, None].expand(B, H, Wp),
        col_ok=col_ok,
        gt_csa=packed["gt_csa"],
        gt_class=packed["gt_class"],
        gt_valid=packed["gt_valid"],
    )
    if "gt_num_points" in packed:
        out["gt_num_points"] = packed["gt_num_points"]
    return out


def finalize_inputs(raw: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Normalize / stack / zero-pad the raw fields into the training-batch
    contract: the device twin of record_to_inputs' tail (data/waymo.py)."""
    col_ok = raw["col_ok"]
    pc = raw["pc"]
    rng = raw["range_value"]
    maskf = raw["mask"].float()
    chans = {
        "range_value": rng,
        "intensity": raw["intensity"],
        "elongation": raw["elongation"],
        "x": pc[..., 0],
        "y": pc[..., 1],
        "z": pc[..., 2],
        "inclination": raw["inclination"],
        "azimuth": torch.atan2(pc[..., 1], pc[..., 0]),
    }
    input_data = torch.stack([_norm(n, chans[n]) for n in CHANNELS], dim=-1)
    input_data = torch.where(col_ok[..., None], input_data, 0.0)

    out = dict(
        input_data=input_data,
        coord=input_data[..., 3:6].contiguous(),
        pc=pc,
        mask=maskf[..., None],
        unnorm_range=(rng.clamp(0.0, 80.0) * maskf)[..., None],
        # padded pixels carry 0.0 (record_to_inputs zero-pads every plane)
        is_in_nlz=torch.where(col_ok, raw["is_in_nlz"], 0.0)[..., None],
        gt_csa=raw["gt_csa"],
        gt_class=raw["gt_class"],
        gt_valid=raw["gt_valid"],
    )
    if "gt_num_points" in raw:
        out["gt_num_points"] = raw["gt_num_points"]
    return out


def expand_inputs(packed: Dict[str, torch.Tensor], valid_w: int
                  ) -> Dict[str, torch.Tensor]:
    """Reconstruct the full training-batch dict from a BATCHED packed dict
    (leading batch dim on every field) on its device."""
    return finalize_inputs(unpack_raw(packed, valid_w))


def draw_augment(B: int, W: int, generator: torch.Generator,
                 names: Sequence[str] = ("flip", "rotation")):
    """Per-frame draws on the generator's device: do_flip (B,) bool ~
    Bernoulli(0.5) when "flip" is named, shift (B,) int32 = theta ~ U(-pi/4,
    pi/4) quantized to whole columns of the W image columns when "rotation"
    is named (the host op's lattice); None for an augmentation not named."""
    dev = generator.device
    do_flip = shift = None
    if "flip" in names:
        do_flip = torch.rand(B, generator=generator, device=dev) < 0.5
    if "rotation" in names:
        theta = (torch.rand(B, generator=generator, device=dev)
                 * (math.pi / 2) - math.pi / 4)
        shift = torch.round(theta / (2 * math.pi) * W).to(torch.int32)
    return do_flip, shift


def augment_raw(raw: Dict[str, torch.Tensor], valid_w: int,
                generator: Optional[torch.Generator] = None,
                names: Sequence[str] = ("flip", "rotation"),
                do_flip: Optional[torch.Tensor] = None,
                shift: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
    """On-device geometric augmentation, the torch twin of data/augment.py
    (world_flip, world_rotation), applied to unpack_raw's raw fields.
    Column ops wrap within the valid_w image columns only (padding is
    untouched).

    Randomness: pass ``generator`` to draw per frame (``draw_augment``), or
    explicit ``do_flip`` (B,) bool / ``shift`` (B,) int for deterministic
    twins (the equality tests). The host order is flip, then rotation."""
    B, H, Wp = raw["mask"].shape
    W = valid_w
    dev = raw["mask"].device
    if generator is not None:
        f, s = draw_augment(B, W, generator, names)
        do_flip = f if do_flip is None else do_flip
        shift = s if shift is None else shift
    if do_flip is None:
        do_flip = torch.zeros(B, dtype=torch.bool, device=dev)
    if shift is None:
        shift = torch.zeros(B, dtype=torch.int32, device=dev)
    do_flip, shift = do_flip.to(dev), shift.to(dev).long()
    theta = shift.float() * (2 * math.pi / W)

    j = torch.arange(Wp, device=dev)
    # the composed source map is flip((j - shift) mod W); padding identity
    src = torch.where(j < W, torch.remainder(j[None, :] - shift[:, None], W),
                      j[None, :])
    src = torch.where(do_flip[:, None] & (src < W), W - 1 - src, src)

    def take_cols(a):  # (B, H, Wp, ...) gather along the column axis
        idx = src.reshape((B, 1, Wp) + (1,) * (a.dim() - 3))
        return torch.gather(a, 2, idx.expand(a.shape))

    out = dict(raw)
    for k in ("range_value", "intensity", "elongation", "mask",
              "is_in_nlz", "inclination"):
        out[k] = take_cols(raw[k])
    pc = take_cols(raw["pc"])
    # flip: y -> -y; then rotate about z by theta
    y = torch.where(do_flip[:, None, None], -pc[..., 1], pc[..., 1])
    c = torch.cos(theta)[:, None, None]
    s = torch.sin(theta)[:, None, None]
    out["pc"] = torch.stack(
        [c * pc[..., 0] - s * y, s * pc[..., 0] + c * y, pc[..., 2]], dim=-1)

    gt = raw["gt_csa"]
    gy = torch.where(do_flip[:, None], -gt[:, :, 1], gt[:, :, 1])
    gyaw = torch.where(do_flip[:, None], -gt[:, :, 6], gt[:, :, 6])
    cb, sb = torch.cos(theta)[:, None], torch.sin(theta)[:, None]
    # padded (invalid) rows stay all-zero, as the host pads AFTER augmenting
    gvalid = raw["gt_valid"]
    out["gt_csa"] = torch.stack(
        [cb * gt[:, :, 0] - sb * gy, sb * gt[:, :, 0] + cb * gy,
         gt[:, :, 2], gt[:, :, 3], gt[:, :, 4], gt[:, :, 5],
         (gyaw + theta[:, None]) * gvalid], dim=-1)
    return out
