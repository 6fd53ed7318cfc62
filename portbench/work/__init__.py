"""The work a RangeDet step needs, from a configuration's widths: the
FLOPs of its contractions and the least time of its conv3x3 and
Meta-Kernel kernels on one H100 (the roofline bounds).

FLOPs count the contractions only (2 x multiply-adds of every conv,
transposed conv, 1x1 conv and Meta-Kernel MLP and aggregation);
elementwise work (BatchNorm, relu, losses, targets) is left out, so a
share of the peak from them is a lower bound. A training step costs
three forwards (the data and weight gradients each one), recompute not
counted.

A bound is the larger of the contractions at the bf16 tensor-core peak
and the bytes every input read once and every output written once take at
the memory's peak, per launch, summed over a step's launches. The
Meta-Kernel's bounds are ``tools/profile_meta.py``'s tensor-core bound:
its contractions at the bf16 peak, the rest of its operations at the f32
peak, or its bytes, whichever is longest.
"""
from __future__ import annotations

from typing import Iterator, Tuple

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
BF16, F32 = 2, 4

AGG_NODES = (("agg2", "res2", "res3", 8, 4), ("agg1", "res1", "res2", 8, 4),
             ("agg2a", "res2a", "agg2", 4, 2), ("agg3", "agg1", "agg2a", 4, 2))
STAGES = (("res1", "data", 1), ("res2a", "res1", 2), ("res2", "res2a", 2),
          ("res3a", "res2", 2), ("res3", "res3a", 2))
LEVELS = {1: "agg3", 2: "agg2a", 4: "agg2", 16: "res3"}

# one 3x3 conv: (Ci, Co, W_in, W_out, input is the data)
Conv = Tuple[int, int, int, int, bool]
# one transposed conv (3, kw), stride s: (Ci, Co, W_in, kw, s)
Deconv = Tuple[int, int, int, int, int]


def _widths(c: dict):
    W = c["pad_field"][1]
    ch, wd = {"data": c["in_channels"]}, {"data": W}
    for name, src, s in STAGES:
        ch[name], wd[name] = c["num_filter"][name], wd[src] // s
    for name, _, up, _, s in AGG_NODES:
        ch[name], wd[name] = c["num_filter"][name], wd[up] * s
    return ch, wd


def convs(c: dict) -> Iterator[Conv]:
    """Every 3x3 conv of the forward, the Meta-Kernel unit's conv1 left
    out (the block replaces it). A unit 1 runs conv1 at the stage's input
    width and carries the stride on conv2."""
    ch, wd = _widths(c)
    stages = [(n, ch[src], wd[src]) for n, src, _ in STAGES]
    stages += [(n, ch[n], wd[n]) for n, *_ in AGG_NODES]
    for name, ci, w_in in stages:
        co = ch[name]
        for i in range(1, c["num_block"][name] + 1):
            cin, win = (ci, w_in) if i == 1 else (co, wd[name])
            if f"{name}_unit{i}" not in c["meta_units"]:
                yield cin, co, win, win, name == "res1" and i == 1
            yield co, co, win, wd[name], False
    for lvl_ci, lvl_w in levels(c):
        for kind in ("cls", "reg"):
            ci = lvl_ci
            for _ in range(c[f"{kind}_conv_layers"]):
                co = c[f"{kind}_conv_channel"]
                yield ci, co, lvl_w, lvl_w, False
                ci = co


def shortcuts(c: dict):
    """(Ci, Co, W_out) of each unit 1's 1x1 shortcut."""
    ch, wd = _widths(c)
    for name, src, _ in STAGES:
        yield ch[src], ch[name], wd[name]
    for name, *_ in AGG_NODES:
        yield ch[name], ch[name], wd[name]


def deconvs(c: dict) -> Iterator[Deconv]:
    ch, wd = _widths(c)
    for name, _, up, kw, s in AGG_NODES:
        yield ch[up], ch[name], wd[up], kw, s


def levels(c: dict):
    """(channels, width) of each FPN level's features."""
    ch, wd = _widths(c)
    for s in c["fpn_strides"]:
        extra = c["in_channels"] if s == 1 and c["add_data_sc"] else 0
        yield ch[LEVELS[s]] + extra, wd[LEVELS[s]]


def meta_shapes(c: dict):
    """(C, Cm, Co, W) of each Meta-Kernel block."""
    ch, wd = _widths(c)
    for unit, spec in c["meta_units"].items():
        stage = unit.split("_unit")[0]
        cm, cc = spec["channel_list"]
        yield cc, cm, ch[stage], wd[stage]


def forward_flops(c: dict) -> float:
    """Contraction FLOPs of one frame's forward."""
    H = c["pad_field"][0]
    f = sum(2 * H * wo * ci * co * 9 for ci, co, _, wo, _ in convs(c))
    f += sum(2 * H * w * ci * co * 3 * kw for ci, co, w, kw, _ in deconvs(c))
    f += sum(2 * H * w * ci * co for ci, co, w in shortcuts(c))
    for cc, cm, co, w in meta_shapes(c):
        f += 2 * 9 * H * w * (3 * cm + cm * cc) + 2 * H * w * 9 * cc * co
    k = c["num_classes"]
    for _, w in levels(c):
        f += 2 * H * w * (c["cls_conv_channel"] * k
                          + c["reg_conv_channel"] * k * c["num_reg_delta"])
    return float(f)


def train_flops(c: dict) -> float:
    return 3.0 * forward_flops(c)


def _bound_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_BF16, nbytes / PEAK_BYTES)


def conv3x3_bound_s(c: dict, frames: int, train: bool) -> float:
    """Least time of one step's 3x3 convs and transposed convs: the
    forward, and in training the data gradient (none for the data input)
    and the weight gradient."""
    H = c["pad_field"][0]
    n = frames * H
    t = 0.0
    # (input bytes, output bytes, weight values, FLOPs, input is the data)
    layers = [(n * wi * ci, n * wo * co, 9 * ci * co,
               2.0 * n * wo * 9 * ci * co, data)
              for ci, co, wi, wo, data in convs(c)]
    layers += [(n * w * ci, n * w * s * co, 3 * kw * ci * co,
                2.0 * n * w * 3 * kw * ci * co, False)
               for ci, co, w, kw, s in deconvs(c)]
    for x, y, w, flops, data in layers:
        t += _bound_s(flops, BF16 * (x + y + w))
        if train:
            if not data:
                t += _bound_s(flops, BF16 * (y + w + x))
            t += _bound_s(flops, BF16 * (x + y) + F32 * w)
    return t


def meta_work(kind: str, B: int, H: int, W: int, C: int, Cm: int, Co: int):
    """(operations, bytes) of one launch of a Meta-Kernel kernel over
    B*H*W pixels, a copy of ``tools/profile_meta.py:meta_work``."""
    taps = 2 * C * Cm + 7 * Cm + 2 * C
    per = {"taps": taps, "stats": taps + 3 * C,
           "agg": taps + 3 * C + 2 * C * Co,
           "bwd_agg": taps + 4 * C * Co + 8 * C + 4 * C * Cm + 9 * Cm,
           "bwd_stats": taps + 6 * C + 4 * C * Cm + 9 * Cm}[kind]
    n = B * H * W
    feat = 2 * n * (C + 3)
    weights = 4 * (4 * Cm + Cm * C + C + (0 if kind == "taps" else 2 * 9 * C))
    out = {"taps": 2 * n * 9 * C,
           "stats": 4 * 2 * 9 * C, "agg": 2 * n * Co + 2 * 9 * C * Co,
           "bwd_agg": 2 * n * (C + 2 * Co) + 2 * 9 * C * Co
           + 4 * (9 * C * Co + 2 * 9 * C + 4 * Cm + Cm * C + C),
           "bwd_stats": 2 * n * C + 4 * (4 * Cm + Cm * C + C)}[kind]
    return 9 * n * per, feat + weights + out


def meta_bound_s(kind: str, B: int, H: int, W: int, C: int, Cm: int,
                 Co: int) -> float:
    """``tools/profile_meta.py:tc_bound_ms`` in seconds."""
    ops, nbytes = meta_work(kind, B, H, W, C, Cm, Co)
    per = {"taps": 2 * C * Cm, "stats": 2 * C * Cm,
           "agg": 2 * C * Cm + 2 * C * Co,
           "bwd_agg": 6 * C * Cm + 4 * C * Co, "bwd_stats": 6 * C * Cm}[kind]
    mma = 9 * B * H * W * per
    return max(mma / PEAK_BF16, (ops - mma) / PEAK_F32, nbytes / PEAK_BYTES)


def meta_block_bound_s(c: dict, frames: int) -> float:
    """One training step's fused Meta-Kernel launches: stats, agg, and the
    backward in its agg and stats modes."""
    H = c["pad_field"][0]
    return sum(meta_bound_s(k, frames, H, w, cc, cm, co)
               for cc, cm, co, w in meta_shapes(c)
               for k in ("stats", "agg", "bwd_agg", "bwd_stats"))


def meta_taps_bound_s(c: dict, frames: int) -> float:
    """One eval forward's taps launches (kernel 7)."""
    H = c["pad_field"][0]
    return sum(meta_bound_s("taps", frames, H, w, cc, cm, co)
               for cc, cm, co, w in meta_shapes(c))
