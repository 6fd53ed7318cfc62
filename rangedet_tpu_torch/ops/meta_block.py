"""The fused Meta-Kernel block over (B, H, C, W): Meta-Kernel taps ->
BatchNorm(9C) fold -> relu -> 1x1 aggregation, with the (B, H, 9C, W)
tensor of tap products never materialized. Counterpart of
``rangedet_tpu/ops/meta_block_pallas.py``; the kernels are
``csrc/meta_block.cu``.

* ``meta_stats(feat, cb, w0, b0, w1, b1)`` is ``meta_stats_pallas``:
  (sum a, sum a^2) per channel of the 9C tap products a.
* ``meta_agg(..., s9, b9, agg)`` is ``meta_agg_pallas``: relu(a*s9 + b9)
  contracted with agg (9C, Co) in f32 -> (B, H, Co, W).
* ``meta_bwd(..., extras, mode)`` is ``_bwd_call``: "agg" with extras
  (s9, b9, agg, gy) -> dfeat, dA, ds9, db9 and the MLP gradients;
  "stats" with extras (c1, c2), da = c1 + c2*a -> dfeat and the MLP
  gradients.
* ``MetaStats`` and ``MetaAgg`` are the custom VJPs ``meta_stats_bhcw``
  and ``meta_agg_bhcw`` as ``torch.autograd.Function``s.

A tap (``_taps_row``): rel = coords of the neighbour - coords of the centre
in f32 (zero padding, so a border tap's rel is -centre); h1 = relu(rel @ w0
+ b0); wt = h1 @ w1 + b1; a = neighbour features * wt rounded to the
features' dtype. Weights are in the JAX package's layout: w0 (3, Cm), b0
(Cm,), w1 (Cm, C), b1 (C,); the ops round them to feat.dtype and compute in
f32, as the block casts them before the Pallas call. Gradients come back in
f32. Coordinates get no gradient.

``plan_meta`` is the geometry of the tensor-core kernels (meta_stats,
meta_agg and the eval taps of ``ops/meta_kernel.py``, which share one
forward kernel, and the block backward: chunks, TMA boxes, the tap order,
the order of the partials) and ``split_bf16`` the exact split of an f32
operand into bf16 terms that they feed to the tensor cores;
``tests/test_torch_meta_plan.py`` drives a CPU emulation of the kernels
with both. All of them form the same tap product a, the plain version's.

A CPU tensor goes to the plain version; a CUDA tensor goes to the kernel or
raises. The Functions look the three ops up on this module at call time, so
patching them (as chip_smoke does with the plain versions) routes the
forward and the backward alike.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .. import _build
from .conv3x3 import _need, _ptr, _route, _stream

TAPS = [(dy, dx) for dy in range(3) for dx in range(3)]

# kernel launches since the last reset; each wrapper adds one per call that
# launches its kernel (its reducing pass included)
STATS_LAUNCHES = 0  # meta_stats_fwd
AGG_LAUNCHES = 0    # meta_agg_fwd
BWD_LAUNCHES = 0    # meta_block_bwd, either mode


def reset_counts() -> None:
    global STATS_LAUNCHES, AGG_LAUNCHES, BWD_LAUNCHES
    STATS_LAUNCHES = AGG_LAUNCHES = BWD_LAUNCHES = 0


def _check(feat, cb, w0, b0, w1, b1):
    if feat.dim() != 4:
        raise ValueError(f"feat must be (B, H, C, W), got {tuple(feat.shape)}")
    B, H, C, W = feat.shape
    Cm = w0.shape[1]
    if tuple(cb.shape) != (B, H, 3, W):
        raise ValueError(f"cb must be {(B, H, 3, W)}, got {tuple(cb.shape)}")
    for name, t, shape in (("w0", w0, (3, Cm)), ("b0", b0, (Cm,)),
                           ("w1", w1, (Cm, C)), ("b1", b1, (C,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")


def _weights(feat, ws: Sequence[torch.Tensor]):
    """Round to feat.dtype, then f32 (the block's cast before the call)."""
    return [w.to(feat.dtype).float().contiguous() for w in ws]


# ---------------------------------------------------------------- plain
def _taps(feat, cb, w0, b0, w1, b1):
    """Yields (t, a, h1, rel, wt, nb) per tap, all f32 (B, H, ., W)."""
    B, H, C, W = feat.shape
    w0, b0, w1, b1 = _weights(feat, (w0, b0, w1, b1))
    center = cb.to(feat.dtype).float()
    cp = F.pad(center, (1, 1, 0, 0, 1, 1))
    fp = F.pad(feat.float(), (1, 1, 0, 0, 1, 1))
    for t, (dy, dx) in enumerate(TAPS):
        rel = cp[:, dy:dy + H, :, dx:dx + W] - center  # (B, H, 3, W)
        h1 = (w0[0][:, None] * rel[:, :, 0:1] + w0[1][:, None] * rel[:, :, 1:2]
              + w0[2][:, None] * rel[:, :, 2:3] + b0[:, None])
        h1 = torch.relu(h1)  # (B, H, Cm, W)
        wt = torch.einsum("bhkw,kc->bhcw", h1, w1) + b1[:, None]
        nb = fp[:, dy:dy + H, :, dx:dx + W]
        a = (nb * wt).to(feat.dtype).float()
        yield t, a, h1, rel, wt, nb


def meta_stats_plain(feat, cb, w0, b0, w1, b1):
    """(sum a, sum a^2) over B, H, W per channel of 9C, f32."""
    _check(feat, cb, w0, b0, w1, b1)
    s1, s2 = [], []
    for _, a, *_ in _taps(feat, cb, w0, b0, w1, b1):
        s1.append(a.sum(dim=(0, 1, 3)))
        s2.append((a * a).sum(dim=(0, 1, 3)))
    return torch.cat(s1), torch.cat(s2)


def meta_agg_plain(feat, cb, w0, b0, w1, b1, s9, b9, agg,
                   out_dtype: Optional[torch.dtype] = None):
    """sum over taps of agg_t^T relu(a_t*s9_t + b9_t), f32, returned in
    ``out_dtype`` (default feat.dtype)."""
    _check(feat, cb, w0, b0, w1, b1)
    C = feat.shape[2]
    A = agg.to(feat.dtype).float()
    s9, b9 = s9.float(), b9.float()
    acc = None
    for t, a, *_ in _taps(feat, cb, w0, b0, w1, b1):
        sl = slice(t * C, (t + 1) * C)
        r = torch.relu(a * s9[sl, None] + b9[sl, None])
        o = torch.einsum("bhcw,co->bhow", r, A[sl])
        acc = o if acc is None else acc + o
    return acc.to(out_dtype or feat.dtype).contiguous()


def meta_bwd_plain(feat, cb, w0, b0, w1, b1, extras, mode: str,
                   out_dtype: Optional[torch.dtype] = None):
    """The block backward, written out tap by tap as ``_bwd_kernel``.
    mode "agg", extras (s9, b9, agg, gy): returns (dfeat, dA (9C, Co), ds9,
    db9, dw0 (3, Cm), db0, dw1 (Cm, C), db1); mode "stats", extras (c1,
    c2): (dfeat, dw0, db0, dw1, db1). dfeat in ``out_dtype`` (default
    feat.dtype), the rest f32."""
    _check(feat, cb, w0, b0, w1, b1)
    B, H, C, W = feat.shape
    Cm = w0.shape[1]
    w1f = _weights(feat, (w1,))[0]
    dfp = feat.new_zeros((B, H + 2, C, W + 2), dtype=torch.float32)
    dw0 = feat.new_zeros((3, Cm), dtype=torch.float32)
    db0 = feat.new_zeros((Cm,), dtype=torch.float32)
    dw1 = feat.new_zeros((Cm, C), dtype=torch.float32)
    db1 = feat.new_zeros((C,), dtype=torch.float32)
    dA, ds9, db9 = [], [], []
    if mode == "agg":
        s9, b9, agg, gy = extras
        A = agg.to(feat.dtype).float()
        gyf = gy.float()
        s9, b9 = s9.float(), b9.float()
    elif mode == "stats":
        c1, c2 = (e.float() for e in extras)
    else:
        raise ValueError(f"mode must be 'agg' or 'stats', got {mode!r}")
    for t, a, h1, rel, wt, nb in _taps(feat, cb, w0, b0, w1, b1):
        dy, dx = TAPS[t]
        sl = slice(t * C, (t + 1) * C)
        if mode == "agg":
            z = a * s9[sl, None] + b9[sl, None]
            darelu = torch.einsum("bhow,co->bhcw", gyf, A[sl])
            dz = torch.where(z > 0, darelu, torch.zeros_like(darelu))
            dA.append(torch.einsum("bhcw,bhow->co", torch.relu(z), gyf))
            ds9.append((dz * a).sum(dim=(0, 1, 3)))
            db9.append(dz.sum(dim=(0, 1, 3)))
            da = dz * s9[sl, None]
        else:
            da = c1[sl, None] + c2[sl, None] * a
        dfp[:, dy:dy + H, :, dx:dx + W] += da * wt
        dwt = da * nb
        db1 += dwt.sum(dim=(0, 1, 3))
        dw1 += torch.einsum("bhcw,bhkw->kc", dwt, h1)
        dh1 = torch.einsum("bhcw,kc->bhkw", dwt, w1f)
        dh1 = torch.where(h1 > 0, dh1, torch.zeros_like(dh1))
        db0 += dh1.sum(dim=(0, 1, 3))
        for j in range(3):
            dw0[j] += (dh1 * rel[:, :, j:j + 1]).sum(dim=(0, 1, 3))
    dfeat = dfp[:, 1:H + 1, :, 1:W + 1].to(out_dtype or feat.dtype)
    dfeat = dfeat.contiguous()
    if mode == "agg":
        return (dfeat, torch.stack(dA).reshape(9 * C, -1), torch.cat(ds9),
                torch.cat(db9), dw0, db0, dw1, db1)
    return dfeat, dw0, db0, dw1, db1


# ------------------------------------------- the tensor-core kernels' plan
TQ = 64             # pixels of a chunk: wgmma's M
GROUP = 64          # channels of a group: a block's tiles
HALO = 8            # box columns left of a chunk: 16 bytes of bf16
BOXW = TQ + 2 * HALO  # width of a box of the shifted rows
# the kernels recompute wt in the plain version's order where nb * wt lies
# within NEAR_TIE * |nb| * sum_k |h1 W1| of a bf16 rounding boundary
NEAR_TIE = 2.0 ** -21


def split_bf16(x: torch.Tensor, terms: int = 3) -> List[torch.Tensor]:
    """bf16 tensors t_0, .., t_{terms-1} with t_0 = bf16(x), t_i =
    bf16(x - t_0 - .. - t_{i-1}). Three terms hold an f32 x exactly (24
    significand bits; every difference is exact in f32), so three bf16
    products with an exact bf16 factor, summed in f32, give the f32
    products (csrc/meta_block.cu)."""
    out, r = [], x.float()
    for _ in range(terms):
        t = r.to(torch.bfloat16)
        out.append(t)
        r = r - t.float()
    return out


FORWARD_KINDS = ("stats", "agg", "taps")


@dataclass(frozen=True)
class MetaPlan:
    """Geometry of one launch of csrc/meta_block.cu's forward kernel
    (kinds "stats", "agg", "taps": meta_stats, meta_agg, the eval taps) or
    of the block backward ("bwd"), which compute the same formulas.

    A chunk is TQ pixels of one row. The forward: the rows 0 .. H-1, chunk
    columns w0 = kq*TQ; its TMA boxes hold feature and coordinate rows h-1
    .. h+1 from column w0 - HALO, BOXW wide. meta_stats sums the chunk's
    columns < W; the taps store each tap's (C, TQ) tile of a at rows t*C ..
    of the output, columns >= W clipped. The backward walks OUTPUT
    chunks (the gather form): rows hq = -1 .. H and columns q0 = kq*TQ -
    HALO, nq chunks a row covering -HALO .. W, so that every (source, tap)
    pair of the image is visited once; its boxes: the feature row hq from
    q0 (TQ wide), coordinate and gy rows hq-1 .. hq+1 from q0 - HALO
    (BOXW). Tap t = (dy, dx) of output pixel q takes the source s = q -
    (dy-1, dx-1): box row 2 - dy, box column q - q0 + HALO + 1 - dx. Every
    box starts on 16 bytes along W. Rows are W wide at a pitch rounded up
    to 8 (16-byte TMA strides). Block i (one warpgroup) takes chunks
    [begin, end) = (chunks*i // blocks, chunks*(i+1) // blocks), in order,
    taps inside; the agg tile of its n-th tap streams into tile n % 2. The
    backward's partials are added per block in chunk order, then over
    blocks in order.

    Channel groups: a block's tiles hold GROUP = 64 of the C channels, so
    at C = 128 there are two groups, g = 0 (channels 0..63) and 1. meta_agg
    sums every group into y: a block walks its chunks, and in each chunk
    the groups in order (its units), taps inside. The other kinds give
    each block one group: block i takes group i % groups and the chunk
    range of i // groups among the blocks // groups of that group (block i
    > 0 of C = 64 is group 0). Their partials hold the group's channels;
    the reduction adds, for each element, the partials of the blocks of
    its group in block order (dW0 and db0: every block's)."""
    kind: str
    B: int
    H: int
    W: int
    blocks: int
    C: int = 64

    @property
    def pitch(self) -> int:
        return -(-self.W // 8) * 8

    @property
    def forward(self) -> bool:
        return self.kind in FORWARD_KINDS

    @property
    def nq(self) -> int:
        if self.forward:
            return -(-self.W // TQ)
        return -(-(self.W + HALO + 1) // TQ)

    @property
    def rows(self) -> int:
        return self.H if self.forward else self.H + 2

    @property
    def chunks(self) -> int:
        return self.B * self.rows * self.nq

    @property
    def groups(self) -> int:
        return self.C // GROUP

    @property
    def grid_groups(self) -> int:
        """Channel groups split over the blocks (meta_agg: none)."""
        return 1 if self.kind == "agg" else self.groups

    def block_group(self, i: int) -> int:
        """The group of block i (meta_agg: 0, the first of its units)."""
        return i % self.grid_groups

    def block_range(self, i: int) -> Tuple[int, int]:
        j, n = i // self.grid_groups, self.blocks // self.grid_groups
        return self.chunks * j // n, self.chunks * (j + 1) // n

    def units(self, i: int) -> List[Tuple[int, int]]:
        """Block i's (chunk, group) in its order."""
        inner = self.groups // self.grid_groups
        g0 = self.block_group(i) * inner
        return [(ch, g0 + gi) for ch in range(*self.block_range(i))
                for gi in range(inner)]

    def chunk(self, ch: int) -> Tuple[int, int, int]:
        """(b, row, first column) of chunk ch: (b, h, w0) for the forward,
        (b, hq, q0) for the backward."""
        kq, rest = ch % self.nq, ch // self.nq
        if self.forward:
            return rest // self.H, rest % self.H, kq * TQ
        return rest // self.rows, rest % self.rows - 1, kq * TQ - HALO

    def boxes(self, ch: int):
        """name -> (column, first row, rows, width) of the chunk's boxes,
        the column innermost (it must start on 16 bytes)."""
        b, h, c0 = self.chunk(ch)
        if self.forward:
            return {"feat": (c0 - HALO, h - 1, 3, BOXW),
                    "crd": (c0 - HALO, h - 1, 3, BOXW)}
        return {"feat": (c0, h, 1, TQ), "crd": (c0 - HALO, h - 1, 3, BOXW),
                "gy": (c0 - HALO, h - 1, 3, BOXW)}


def plan_meta(kind: str, B: int, H: int, W: int, blocks: int,
              C: int = 64) -> MetaPlan:
    if kind not in (*FORWARD_KINDS, "bwd"):
        raise ValueError(f"kind must be one of {(*FORWARD_KINDS, 'bwd')}, "
                         f"got {kind!r}")
    if C % GROUP:
        raise ValueError(f"C must be a multiple of {GROUP}, got {C}")
    plan = MetaPlan(kind, B, H, W, blocks, C)
    if blocks % plan.grid_groups:
        raise ValueError(f"{blocks} blocks for {plan.grid_groups} groups")
    return plan


def _pitched(t, pitch):
    """t (B, H, ., W) bf16 as rows of ``pitch`` elements, 16-byte aligned:
    itself, or a zero-padded copy."""
    W = t.shape[-1]
    if pitch == W and t.data_ptr() % 16 == 0:
        return t
    out = t.new_zeros(t.shape[:-1] + (pitch,))
    out[..., :W] = t
    return out


# ---------------------------------------------------------------- kernels
# the widths (C, Cm, Co) the kernels are built for (csrc/meta_block.cu's
# instances, chosen there by C; meta_stats and the taps read no Co)
BUILT_WIDTHS = ((64, 32, 64), (128, 32, 128))


def _kernel_inputs(feat, cb, w0, b0, w1, b1, Co=None):
    """Checks for the kernel, and its f32 weights as they are: the kernels
    round them to bf16 as they load them (on the card the casts of
    ``_weights`` were ten small launches a call). The instance is chosen
    by the widths of the tensors, (C, Cm) and, for meta_agg and the
    backward, ``Co``; a width with no instance raises."""
    if feat.dtype != torch.bfloat16:
        raise TypeError(f"the kernels take bf16 features, got {feat.dtype}")
    _need(feat, "feat", feat, torch.bfloat16)
    B, H, C, W = feat.shape
    Cm = w0.shape[1]
    if not any((C, Cm) == w[:2] and Co in (None, w[2])
               for w in BUILT_WIDTHS):
        raise ValueError(f"no kernel is built for C={C}, Cm={Cm}"
                         + ("" if Co is None else f", Co={Co}")
                         + f"; built: (C, Cm, Co) in {BUILT_WIDTHS}")
    lib = _build.load()
    cbb = cb.to(torch.bfloat16, memory_format=torch.contiguous_format)
    _need(feat, "cb", cbb, torch.bfloat16)
    ws = [w.float().contiguous() for w in (w0, b0, w1, b1)]
    for name, t in zip(("w0", "b0", "w1", "b1"), ws):
        _need(feat, name, t, torch.float32)
    return lib, cbb, ws


def _vec9(feat, name, v, C):
    v = v.float().contiguous()
    _need(feat, name, v, torch.float32, (9 * C,))
    return v


def _agg_weight(feat, agg, C, Co):
    a = agg.to(torch.bfloat16).contiguous()
    _need(feat, "agg", a, torch.bfloat16, (9 * C, Co))
    return a


def _grid(lib, kind, C, B, H, W):
    n = lib.meta_block_grid(kind, C, B, H, W)
    if n <= 0:
        raise RuntimeError(f"meta_block_grid({kind}, C={C}) failed: {n}")
    return n


def _bwd_sum_floats(mode: str, C: int, Cm: int, Co: int) -> int:
    """Floats of the backward's reduced sums: mode "agg" [dA (9C, Co), ds9,
    db9] then the MLP's [dW0 (3, Cm), db0, dW1 (Cm, C), db1]; "stats" the
    MLP's."""
    mlp = 4 * Cm + Cm * C + C
    return mlp + (9 * C * (Co + 2) if mode == "agg" else 0)


def meta_stats(feat, cb, w0, b0, w1, b1):
    """(sum a, sum a^2) per channel of the 9C tap products. No gradient:
    see MetaStats."""
    global STATS_LAUNCHES
    _check(feat, cb, w0, b0, w1, b1)
    if not _route(feat, "meta_block"):
        return meta_stats_plain(feat, cb, w0, b0, w1, b1)
    lib, cbb, ws = _kernel_inputs(feat, cb, w0, b0, w1, b1)
    B, H, C, W = feat.shape
    plan = plan_meta("stats", B, H, W, _grid(lib, 0, C, B, H, W), C)
    fp, cp = _pitched(feat, plan.pitch), _pitched(cbb, plan.pitch)
    n = lib.meta_block_part_floats(0, C)
    dev = feat.device
    part = torch.empty((plan.blocks, n), dtype=torch.float32, device=dev)
    sums = torch.empty((2, 9 * C), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.meta_stats_fwd(
            fp.data_ptr(), cp.data_ptr(), *(w.data_ptr() for w in ws),
            part.data_ptr(), sums.data_ptr(), C, B, H, W, plan.pitch,
            plan.blocks, _stream(feat))
    if err != 0:
        raise RuntimeError(f"meta_stats_fwd launch failed: cudaError {err}")
    STATS_LAUNCHES += 1
    return sums[0], sums[1]


def meta_agg(feat, cb, w0, b0, w1, b1, s9, b9, agg):
    """The fused block output (B, H, Co, W) in feat.dtype. No gradient:
    see MetaAgg."""
    global AGG_LAUNCHES
    _check(feat, cb, w0, b0, w1, b1)
    if not _route(feat, "meta_block"):
        return meta_agg_plain(feat, cb, w0, b0, w1, b1, s9, b9, agg)
    B, H, C, W = feat.shape
    Co = agg.shape[-1]
    lib, cbb, ws = _kernel_inputs(feat, cb, w0, b0, w1, b1, Co)
    s9f, b9f = _vec9(feat, "s9", s9, C), _vec9(feat, "b9", b9, C)
    a = _agg_weight(feat, agg, C, Co)
    plan = plan_meta("agg", B, H, W, _grid(lib, 1, C, B, H, W), C)
    fp, cp = _pitched(feat, plan.pitch), _pitched(cbb, plan.pitch)
    y = torch.empty((B, H, Co, W), dtype=feat.dtype, device=feat.device)
    with torch.cuda.device(feat.device):
        err = lib.meta_agg_fwd(
            fp.data_ptr(), cp.data_ptr(), *(w.data_ptr() for w in ws),
            s9f.data_ptr(), b9f.data_ptr(), a.data_ptr(), y.data_ptr(),
            C, B, H, W, plan.pitch, plan.blocks, _stream(feat))
    if err != 0:
        raise RuntimeError(f"meta_agg_fwd launch failed: cudaError {err}")
    AGG_LAUNCHES += 1
    return y


def meta_bwd(feat, cb, w0, b0, w1, b1, extras, mode: str):
    """The block backward (see meta_bwd_plain for what it returns)."""
    global BWD_LAUNCHES
    _check(feat, cb, w0, b0, w1, b1)
    if mode not in ("agg", "stats"):
        raise ValueError(f"mode must be 'agg' or 'stats', got {mode!r}")
    if not _route(feat, "meta_block"):
        return meta_bwd_plain(feat, cb, w0, b0, w1, b1, extras, mode)
    B, H, C, W = feat.shape
    Cm = w0.shape[1]
    Co = extras[2].shape[-1] if mode == "agg" else None
    lib, cbb, ws = _kernel_inputs(feat, cb, w0, b0, w1, b1, Co)
    a = gy = None
    if mode == "agg":
        s9, b9, agg, gy = extras
        e0, e1 = _vec9(feat, "s9", s9, C), _vec9(feat, "b9", b9, C)
        a = _agg_weight(feat, agg, C, Co)
        gy = gy.contiguous()
        _need(feat, "gy", gy, torch.bfloat16, (B, H, Co, W))
    else:
        e0, e1 = (_vec9(feat, n, e, C) for n, e in zip(("c1", "c2"), extras))
    kind = 3 if mode == "agg" else 2
    plan = plan_meta("bwd", B, H, W, _grid(lib, kind, C, B, H, W), C)
    fp, cp = _pitched(feat, plan.pitch), _pitched(cbb, plan.pitch)
    if gy is not None:
        gy = _pitched(gy, plan.pitch)
    n = lib.meta_block_part_floats(kind, C)
    dev = feat.device
    part = torch.empty((plan.blocks, n), dtype=torch.float32, device=dev)
    sums = torch.empty((_bwd_sum_floats(mode, C, Cm, Co),),
                       dtype=torch.float32, device=dev)
    dfeat = torch.empty_like(feat)
    with torch.cuda.device(dev):
        err = lib.meta_block_bwd(
            fp.data_ptr(), cp.data_ptr(), *(w.data_ptr() for w in ws),
            e0.data_ptr(), e1.data_ptr(), _ptr(a), _ptr(gy),
            dfeat.data_ptr(), part.data_ptr(), sums.data_ptr(), C, B, H, W,
            plan.pitch, plan.blocks, int(mode == "agg"), _stream(feat))
    if err != 0:
        raise RuntimeError(f"meta_block_bwd launch failed: cudaError {err}")
    BWD_LAUNCHES += 1
    mlp = sums
    out = [dfeat]
    if mode == "agg":
        n9 = 9 * C
        out += [sums[:n9 * Co].view(n9, Co), sums[n9 * Co:n9 * (Co + 1)],
                sums[n9 * (Co + 1):n9 * (Co + 2)]]
        mlp = sums[n9 * (Co + 2):]
    o = 0
    for shape in ((3, Cm), (Cm,), (Cm, C), (C,)):
        size = 1
        for d in shape:
            size *= d
        out.append(mlp[o:o + size].view(shape))
        o += size
    return tuple(out)


# ---------------------------------------------------------------- autograd
class MetaStats(torch.autograd.Function):
    """(s1, s2) = meta_stats(...), with the backward of ``_stats_bwd``:
    the block backward in "stats" mode with (ds1, 2*ds2)."""

    @staticmethod
    def forward(ctx, feat, cb, w0, b0, w1, b1):
        ctx.save_for_backward(feat, cb, w0, b0, w1, b1)
        return meta_stats(feat, cb, w0, b0, w1, b1)

    @staticmethod
    def backward(ctx, ds1, ds2):
        feat, cb, w0, b0, w1, b1 = ctx.saved_tensors
        dfeat, dw0, db0, dw1, db1 = meta_bwd(
            feat, cb, w0, b0, w1, b1, (ds1, 2.0 * ds2), "stats")
        return dfeat, None, dw0, db0, dw1, db1


class MetaAgg(torch.autograd.Function):
    """y = meta_agg(...), with the backward of ``_agg_bwd``: the block
    backward in "agg" mode, giving dfeat, the MLP gradients, ds9, db9 and
    dA."""

    @staticmethod
    def forward(ctx, feat, cb, w0, b0, w1, b1, s9, b9, agg):
        ctx.save_for_backward(feat, cb, w0, b0, w1, b1, s9, b9, agg)
        return meta_agg(feat, cb, w0, b0, w1, b1, s9, b9, agg)

    @staticmethod
    def backward(ctx, gy):
        feat, cb, w0, b0, w1, b1, s9, b9, agg = ctx.saved_tensors
        dfeat, dA, ds9, db9, dw0, db0, dw1, db1 = meta_bwd(
            feat, cb, w0, b0, w1, b1, (s9, b9, agg, gy.contiguous()), "agg")
        return dfeat, None, dw0, db0, dw1, db1, ds9, db9, dA

