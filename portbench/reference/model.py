"""Plain f32 RangeDet forward (backbone, Meta-Kernel block, head), written
from the architecture and independent of the program under test.

Layout (B, C, H, W). Every contraction is a ``torch.nn.functional`` call
in f32; run it with TF32 off (``reference.precision.no_tf32``). ``cast``
is applied to both operands of every contraction and to every tensor a
layer hands on: the identity for the reference, a round trip through a
lower precision for the control (``reference.precision``).

The architecture (RangeDet, ICCV 2021; the DLA backbone of the authors'
rangedet/symbol/backbone/dla_backbone.py):

* a residual BasicBlock: conv1 (3x3, stride 1) - BN - relu - conv2 (3x3,
  the stage's stride on the width) - BN, plus the shortcut (unit 1: a 1x1
  conv over every s-th column, then BN), then relu. The unit named in
  ``meta_units`` replaces conv1 - BN - relu by the Meta-Kernel block;
* a 3x3 conv of stride 2 pads SAME at an even width: 0 columns left, 1
  right;
* the Meta-Kernel block: for each tap of a pixel's 3x3 neighbourhood (tap
  t = 3 dy + dx, zero padding), w = mlp1(relu(mlp0(coords[n] -
  coords[p]))) multiplies the neighbour's features; the 9 products stack
  tap-major into 9C channels - BN - relu - 1x1 conv - BN - relu;
* the agg nodes: a transposed conv of kernel (3, kw), stride (1, s),
  padding (1, (kw - s) / 2) - BN - relu, added to the lateral branch,
  then a stage;
* per FPN level a cls and a reg tower of 3x3 conv - BN - relu, then 1x1
  projections with bias.

BatchNorm has eps 1e-3 and momentum 0.9; in training it normalizes by the
batch's biased variance E[x^2] - E[x]^2 (clamped at 0), in eval by the
running statistics.

The parameters are a flat dict whose names and shapes ``param_specs``
gives; the benchmark draws them (``portbench.weights``) and hands the same
values to the program, whose state dict has the same names.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

BN_EPS = 1e-3
BN_MOMENTUM = 0.9
LECUN_TRUNC = 0.87962566103423978  # std of N(0, 1) truncated at +-2
HEAD_STD = 0.01

# name -> (lateral branch, upsampled branch, deconv kernel, deconv stride)
AGG_NODES = (
    ("agg2", "res2", "res3", (3, 8), 4),
    ("agg1", "res1", "res2", (3, 8), 4),
    ("agg2a", "res2a", "agg2", (3, 4), 2),
    ("agg3", "agg1", "agg2a", (3, 4), 2),
)
STAGES = (("res1", "data", 1), ("res2a", "res1", 2), ("res2", "res2a", 2),
          ("res3a", "res2", 2), ("res3", "res3a", 2))
LEVELS = {1: "agg3", 2: "agg2a", 4: "agg2", 16: "res3"}

Params = Dict[str, torch.Tensor]
Cast = Callable[[torch.Tensor], torch.Tensor]
# one spec: (name, shape, init, std); init in "trunc", "normal", "zeros",
# "ones"
Spec = Tuple[str, Tuple[int, ...], str, float]


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


def _lecun(fan_in: int) -> float:
    return 1.0 / math.sqrt(fan_in) / LECUN_TRUNC


def _bn_specs(name: str, c: int) -> List[Spec]:
    return [(f"{name}.weight", (c,), "ones", 0.0),
            (f"{name}.bias", (c,), "zeros", 0.0),
            (f"{name}.running_mean", (c,), "zeros", 0.0),
            (f"{name}.running_var", (c,), "ones", 0.0)]


def channels(arch: dict) -> Dict[str, int]:
    """Output channels of each backbone node and of each FPN level."""
    ch = {"data": arch["in_channels"]}
    for name, _, _ in STAGES:
        ch[name] = arch["num_filter"][name]
    for name, _, _, _, _ in AGG_NODES:
        ch[name] = arch["num_filter"][name]
    return ch


def level_channels(arch: dict) -> List[int]:
    ch = channels(arch)
    return [ch[LEVELS[s]] + (arch["in_channels"] if s == 1
                             and arch["add_data_sc"] else 0)
            for s in arch["fpn_strides"]]


def _unit_specs(pre: str, ci: int, co: int, proj: bool,
                meta: Optional[dict]) -> List[Spec]:
    out: List[Spec] = []
    if meta:
        cm, c = meta["channel_list"]
        mb = f"{pre}.meta_block"
        out += [(f"{mb}.meta_kernel.mlp0.weight", (cm, 3), "trunc",
                 _lecun(3)),
                (f"{mb}.meta_kernel.mlp0.bias", (cm,), "zeros", 0.0),
                (f"{mb}.meta_kernel.mlp1.weight", (c, cm), "trunc",
                 _lecun(cm)),
                (f"{mb}.meta_kernel.mlp1.bias", (c,), "zeros", 0.0)]
        out += _bn_specs(f"{mb}.meta_bn", 9 * c)
        out += [(f"{mb}.meta_agg.weight", (co, 9 * c, 1, 1), "trunc",
                 _lecun(9 * c))]
        out += _bn_specs(f"{mb}.meta_agg.bn", co)
    else:
        out += [(f"{pre}.conv1.weight", (co, ci, 3, 3), "trunc",
                 _lecun(9 * ci))]
        out += _bn_specs(f"{pre}.conv1.bn", co)
    out += [(f"{pre}.conv2_weight", (co, co, 3, 3), "trunc", _lecun(9 * co))]
    out += _bn_specs(f"{pre}.bn2", co)
    if proj:
        out += [(f"{pre}.sc_weight", (co, ci, 1, 1), "trunc", _lecun(ci))]
        out += _bn_specs(f"{pre}.sc_bn", co)
    return out


def _stage_specs(name: str, ci: int, co: int, arch: dict) -> List[Spec]:
    out: List[Spec] = []
    for i in range(1, arch["num_block"][name] + 1):
        unit = f"{name}_unit{i}"
        out += _unit_specs(f"backbone.{name}.{unit}", ci if i == 1 else co,
                           co, i == 1, arch["meta_units"].get(unit))
    return out


def param_specs(arch: dict) -> List[Spec]:
    """Every parameter and BatchNorm statistic of the model: name, shape,
    and how ``portbench.weights`` draws it (lecun-normal truncated at two
    standard deviations for the backbone's weights, N(0, 0.01^2) for the
    head's, BatchNorm at the identity)."""
    ch = channels(arch)
    specs: List[Spec] = []
    for name, src, _ in STAGES:
        specs += _stage_specs(name, ch[src], ch[name], arch)
    for name, _, up, (kh, kw), _ in AGG_NODES:
        ci, co = ch[up], ch[name]
        specs += [(f"backbone.{name}_deconv.weight", (ci, co, kh, kw),
                   "trunc", _lecun(kh * kw * ci))]
        specs += _bn_specs(f"backbone.{name}_deconv.bn", co)
        specs += _stage_specs(name, co, co, arch)
    k = arch["num_classes"]
    for lvl, cin in enumerate(level_channels(arch)):
        for kind in ("cls", "reg"):
            ci = cin
            c = arch[f"{kind}_conv_channel"]
            for i in range(arch[f"{kind}_conv_layers"]):
                n = f"head.{kind}_conv_{i}_lvl_{lvl}"
                specs += [(f"{n}.weight", (c, ci, 3, 3), "normal", HEAD_STD)]
                specs += _bn_specs(f"{n}.bn", c)
                ci = c
        for name, ci, co in (
                (f"cls_logit_lvl_{lvl}", arch["cls_conv_channel"], k),
                (f"reg_delta_lvl_{lvl}", arch["reg_conv_channel"],
                 k * arch["num_reg_delta"])):
            specs += [(f"head.{name}_weight", (co, ci, 1, 1), "normal",
                       HEAD_STD),
                      (f"head.{name}_bias", (co,), "zeros", 0.0)]
    return specs


def is_trainable(name: str) -> bool:
    return not name.endswith(("running_mean", "running_var"))


class Net:
    """One forward pass over the parameters ``P``. ``train``: BatchNorm on
    the batch's statistics, which it records in ``self.stats``; else on
    the running statistics. The outputs of the backbone's stages named in
    ``keep`` are kept in ``self.kept``."""

    def __init__(self, P: Params, arch: dict, train: bool,
                 cast: Cast = _identity, keep=()):
        self.P, self.arch, self.train, self.cast = P, arch, train, cast
        self.stats: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
        self.keep = tuple(keep)
        self.kept: Dict[str, torch.Tensor] = {}

    # -------------------------------------------------------------- layers
    def bn(self, x: torch.Tensor, name: str) -> torch.Tensor:
        P = self.P
        if self.train:
            mean = x.mean(dim=(0, 2, 3))
            var = ((x * x).mean(dim=(0, 2, 3)) - mean * mean).clamp(min=0.0)
            self.stats[name] = (mean.detach(), var.detach())
        else:
            mean, var = P[f"{name}.running_mean"], P[f"{name}.running_var"]
        inv = torch.rsqrt(var + BN_EPS) * P[f"{name}.weight"]
        add = P[f"{name}.bias"] - mean * inv
        return self.cast(x * inv[None, :, None, None]
                         + add[None, :, None, None])

    def conv3x3(self, x: torch.Tensor, w: torch.Tensor, stride: int = 1
                ) -> torch.Tensor:
        pad = (1, 1, 1, 1) if stride == 1 else (0, 1, 1, 1)
        return self.cast(F.conv2d(self.cast(F.pad(x, pad)), self.cast(w),
                                  stride=(1, stride)))

    def conv1x1(self, x: torch.Tensor, w: torch.Tensor, stride: int = 1
                ) -> torch.Tensor:
        return self.cast(F.conv2d(self.cast(x[..., ::stride]),
                                  self.cast(w)))

    def deconv(self, x: torch.Tensor, w: torch.Tensor, stride: int
               ) -> torch.Tensor:
        kw = w.shape[3]
        return self.cast(F.conv_transpose2d(
            self.cast(x), self.cast(w), stride=(1, stride),
            padding=(1, (kw - stride) // 2)))

    def meta_kernel(self, feat: torch.Tensor, cb: torch.Tensor, pre: str
                    ) -> torch.Tensor:
        """feat (B, C, H, W), cb (B, 3, H, W) -> (B, 9C, H, W)."""
        P, c = self.P, self.cast
        H, W = feat.shape[2:]
        w0, b0 = P[f"{pre}.mlp0.weight"], P[f"{pre}.mlp0.bias"]
        w1, b1 = P[f"{pre}.mlp1.weight"], P[f"{pre}.mlp1.bias"]
        cp = F.pad(cb, (1, 1, 1, 1))
        fp = F.pad(feat, (1, 1, 1, 1))
        taps = []
        for dy in range(3):
            for dx in range(3):
                rel = cp[:, :, dy:dy + H, dx:dx + W] - cb
                h = torch.relu(torch.einsum("bkhw,mk->bmhw", c(rel), c(w0))
                               + b0[None, :, None, None])
                wt = (torch.einsum("bmhw,cm->bchw", c(h), c(w1))
                      + b1[None, :, None, None])
                taps.append(fp[:, :, dy:dy + H, dx:dx + W] * wt)
        return c(torch.cat(taps, dim=1))

    def meta_block(self, x: torch.Tensor, cb: torch.Tensor, pre: str
                   ) -> torch.Tensor:
        mk = self.meta_kernel(x, cb, f"{pre}.meta_kernel")
        mk = torch.relu(self.bn(mk, f"{pre}.meta_bn"))
        y = self.conv1x1(mk, self.P[f"{pre}.meta_agg.weight"])
        return torch.relu(self.bn(y, f"{pre}.meta_agg.bn"))

    def unit(self, x: torch.Tensor, cb: torch.Tensor, pre: str, stride: int,
             proj: bool, meta: bool) -> torch.Tensor:
        P = self.P
        if meta:
            y = self.meta_block(x, cb, f"{pre}.meta_block")
        else:
            y = torch.relu(self.bn(self.conv3x3(x, P[f"{pre}.conv1.weight"]),
                                   f"{pre}.conv1.bn"))
        y = self.bn(self.conv3x3(y, P[f"{pre}.conv2_weight"], stride),
                    f"{pre}.bn2")
        if proj:
            sc = self.bn(self.conv1x1(x, P[f"{pre}.sc_weight"], stride),
                         f"{pre}.sc_bn")
        else:
            sc = x
        return torch.relu(self.cast(y + sc))

    def stage(self, name: str, x: torch.Tensor, cb: torch.Tensor,
              stride: int = 1) -> torch.Tensor:
        for i in range(1, self.arch["num_block"][name] + 1):
            unit = f"{name}_unit{i}"
            x = self.unit(x, cb, f"backbone.{name}.{unit}",
                          stride if i == 1 else 1, i == 1,
                          unit in self.arch["meta_units"])
        return x

    # ------------------------------------------------------------ the model
    def backbone(self, data: torch.Tensor, cb: torch.Tensor
                 ) -> List[torch.Tensor]:
        f = {"data": data}
        for name, src, stride in STAGES:
            f[name] = self.stage(name, f[src], cb, stride)
        for name, const, up, _, stride in AGG_NODES:
            pre = f"backbone.{name}_deconv"
            x_up = torch.relu(self.bn(
                self.deconv(f[up], self.P[f"{pre}.weight"], stride),
                f"{pre}.bn"))
            f[name] = self.stage(name, self.cast(f[const] + x_up), cb)
        self.kept = {k: f[k].detach() for k in self.keep}
        if self.arch["add_data_sc"]:
            f["agg3"] = torch.cat([data, f["agg3"]], dim=1)
        return [f[LEVELS[s]] for s in self.arch["fpn_strides"]]

    def head(self, feats: List[torch.Tensor]
             ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        P, arch = self.P, self.arch
        cls_out, reg_out = [], []
        for lvl, feat in enumerate(feats):
            outs = []
            for kind, proj in (("cls", "cls_logit"), ("reg", "reg_delta")):
                x = feat
                for i in range(arch[f"{kind}_conv_layers"]):
                    n = f"head.{kind}_conv_{i}_lvl_{lvl}"
                    x = torch.relu(self.bn(self.conv3x3(x, P[f"{n}.weight"]),
                                           f"{n}.bn"))
                n = f"head.{proj}_lvl_{lvl}"
                y = self.cast(self.conv1x1(x, P[f"{n}_weight"])
                              + P[f"{n}_bias"][None, :, None, None])
                outs.append(y.permute(0, 2, 3, 1))  # (B, H, W_s, K)
            cls_out.append(outs[0])
            reg_out.append(outs[1])
        return cls_out, reg_out

    def __call__(self, input_data: torch.Tensor, coords: torch.Tensor):
        """input_data (B, H, W, 8), coords (B, H, W, 3) -> per level
        logits (B, H, W_s, K) and deltas (B, H, W_s, 8K), f32."""
        data = self.cast(input_data.float().permute(0, 3, 1, 2))
        cb = coords.float().permute(0, 3, 1, 2)
        return self.head(self.backbone(data, cb))


def update_running_stats(P: Params, stats) -> None:
    """Move each BatchNorm's running statistics by momentum 0.9 towards
    the batch statistics ``Net.stats`` recorded."""
    with torch.no_grad():
        for name, (mean, var) in stats.items():
            rm, rv = P[f"{name}.running_mean"], P[f"{name}.running_var"]
            rm.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * mean)
            rv.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * var)
