"""3x3 convolution over (B, H, C, W) activations and its gradients: the
hand-written Hopper kernels (``csrc/conv3x3_bhcw.cu`` for the forward and
the data gradient, ``csrc/conv3x3_wgrad.cu`` for the weight gradient), their
wrappers and plain versions, and the autograd Function that ties them
together.

Counterpart of ``rangedet_tpu/ops/conv_pallas.py``:

* ``conv3x3_bhcw(x, w, scale, bias, stride_w, stats)`` is ``_conv3x3_fwd``:
  the conv of x, or of the fused producer-BN ingest relu(x*scale + bias)
  (affine in f32, rounded to x.dtype before the multiply-accumulate, as
  ``conv_pallas._ingest``), and with ``stats`` also the per-channel sums
  (sum y, sum y^2) of the stored y. ``stride_w=2`` is XLA SAME for an even
  width (pad 0 left, 1 right); the kernel's prologue phase-packs the
  input and its GEMM runs the stride-1 conv of ``phase_pack``.
* ``conv3x3_dgrad(gy, w, cot, affine)`` is ``_conv3x3_fwd`` as the dgrad:
  the same conv of gy with the flipped, (Ci, Co)-swapped weight; ``cot``
  folds the stats cotangents into gy on load (``_ingest_cot``) and
  ``affine`` finishes the backward of the fused ingest (dx, dscale, dbias).
* ``conv3x3_wgrad(x, gy, scale, bias, cot)`` is ``_conv3x3_wgrad``.
* ``conv3x3(...)`` is the differentiable op: the four custom-VJP entry
  points ``conv3x3_bhcw``, ``conv3x3_bnrelu_bhcw``, ``conv3x3_stats_bhcw``
  and ``conv3x3_bnrelu_stats_bhcw`` in one ``torch.autograd.Function``.
  A stride-2 conv differentiates through the phase identity of
  ``rangedet_tpu/models/layers.py:conv3x3_stride2_phase``.

A CPU tensor goes to the plain version; a CUDA tensor goes to the kernel or
raises. The Function looks the three functions up on this module at call
time, so patching them (as chip_smoke does with the plain versions) routes
the forward and the backward alike.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .. import _build

# kernel launches since the last reset; each wrapper adds one per call that
# launches its kernel (a call's second, reducing pass included)
LAUNCHES = 0        # forward, csrc/conv3x3_bhcw.cu
DGRAD_LAUNCHES = 0  # dgrad, the same kernel with the flipped weight
WGRAD_LAUNCHES = 0  # csrc/conv3x3_wgrad.cu

Cot = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # (y, gs1, gs2)
Affine = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # (x, scale, bias)


def reset_counts() -> None:
    global LAUNCHES, DGRAD_LAUNCHES, WGRAD_LAUNCHES
    LAUNCHES = DGRAD_LAUNCHES = WGRAD_LAUNCHES = 0


def _check(x, w, scale, bias, stride_w):
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, Ci, W), got {tuple(x.shape)}")
    Ci, W = x.shape[2], x.shape[3]
    if w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, Ci):
        raise ValueError(
            f"w must be (3, 3, {Ci}, Co) for x {tuple(x.shape)}, "
            f"got {tuple(w.shape)}"
        )
    if stride_w not in (1, 2):
        raise ValueError(f"stride_w must be 1 or 2, got {stride_w}")
    if stride_w == 2 and W % 2:
        raise ValueError(f"stride 2 needs an even width, got W={W}")
    if (scale is None) != (bias is None):
        raise ValueError("scale and bias come together")
    if scale is not None and (
        tuple(scale.shape) != (Ci,) or tuple(bias.shape) != (Ci,)
    ):
        raise ValueError(f"scale/bias must be ({Ci},)")


def _vec(v: torch.Tensor) -> torch.Tensor:
    return v.float()[None, None, :, None]


def ingest_plain(x: torch.Tensor, scale: Optional[torch.Tensor],
                 bias: Optional[torch.Tensor]) -> torch.Tensor:
    """relu(x*scale + bias) in f32, rounded to x.dtype (_ingest)."""
    if scale is None:
        return x
    return torch.relu(x.float() * _vec(scale) + _vec(bias)).to(x.dtype)


def cot_plain(gy: torch.Tensor, cot: Optional[Cot]) -> torch.Tensor:
    """gy + gs1 + 2*y*gs2 in f32, rounded to gy.dtype (_ingest_cot)."""
    if cot is None:
        return gy
    y, gs1, gs2 = cot
    g = gy.float() + _vec(gs1)
    return (g + 2.0 * y.float() * _vec(gs2)).to(gy.dtype)


def _conv_f32(a: torch.Tensor, w: torch.Tensor, stride_w: int
              ) -> torch.Tensor:
    """f32 SAME conv of (B, H, Ci, W) with (3, 3, Ci, Co) -> (B, H, Co, Wo).

    Exact f32 only with TF32 convolutions off
    (``torch.backends.cudnn.allow_tf32``) on a CUDA tensor."""
    af = a.float().permute(0, 2, 1, 3)  # (B, Ci, H, W)
    wt = w.float().permute(3, 2, 0, 1)  # (Co, Ci, 3, 3)
    if stride_w == 1:
        y = F.conv2d(af, wt, padding=1)
    else:
        y = F.conv2d(F.pad(af, (0, 1, 1, 1)), wt, stride=(1, 2))
    return y.permute(0, 2, 1, 3)


def _channel_sums(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    tf = t.float()
    return tf.sum(dim=(0, 1, 3)), (tf * tf).sum(dim=(0, 1, 3))


def flip_weight(w: torch.Tensor) -> torch.Tensor:
    """The dgrad's weight: w rotated 180 degrees, (Ci, Co) swapped."""
    return w.flip(0, 1).transpose(2, 3)


def conv3x3_bhcw_plain(
    x: torch.Tensor,
    w: torch.Tensor,
    scale: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    stride_w: int = 1,
    stats: bool = False,
    out_dtype: Optional[torch.dtype] = None,
):
    """Reference: torch ops in f32 on the same operands, the ingest rounded
    to x.dtype, the output in ``out_dtype`` (default x.dtype); with
    ``stats`` also (sum y, sum y^2) of y rounded to x.dtype."""
    _check(x, w, scale, bias, stride_w)
    acc = _conv_f32(ingest_plain(x, scale, bias), w, stride_w)
    y = acc.to(out_dtype or x.dtype).contiguous()
    if not stats:
        return y
    return (y, *_channel_sums(acc.to(x.dtype)))


def conv3x3_dgrad_plain(gy: torch.Tensor, w: torch.Tensor,
                        cot: Optional[Cot] = None,
                        affine: Optional[Affine] = None,
                        out_dtype: Optional[torch.dtype] = None):
    """Reference dgrad (stride 1): the conv of the cot-adjusted gy with
    flip_weight(w), in f32. With ``affine`` = (x, scale, bias) of the fused
    forward relu(x*scale + bias): dz = acc where x*scale + bias > 0, and
    returns (bf16(dz*scale), sum dz*x, sum dz) per channel."""
    acc = _conv_f32(cot_plain(gy, cot), flip_weight(w), 1)
    dtype = out_dtype or gy.dtype
    if affine is None:
        return acc.to(dtype).contiguous()
    x, scale, bias = affine
    xf = x.float()
    dz = torch.where(xf * _vec(scale) + _vec(bias) > 0, acc,
                     torch.zeros_like(acc))
    dx = (dz * _vec(scale)).to(dtype).contiguous()
    return dx, (dz * xf).sum(dim=(0, 1, 3)), dz.sum(dim=(0, 1, 3))


def conv3x3_wgrad_plain(x: torch.Tensor, gy: torch.Tensor,
                        scale: Optional[torch.Tensor] = None,
                        bias: Optional[torch.Tensor] = None,
                        cot: Optional[Cot] = None) -> torch.Tensor:
    """Reference weight gradient (stride 1), f32 (3, 3, Ci, Co):
    dW[dy, dx] = sum over b, h, w of a[h+dy-1, :, w+dx-1] g[h, :, w]^T with
    a the zero-padded ingest of x and g the cot-adjusted gy."""
    a = ingest_plain(x, scale, bias).float()
    g = cot_plain(gy, cot).float()
    H, W = x.shape[1], x.shape[3]
    ap = F.pad(a, (1, 1, 0, 0, 1, 1))  # pad W and H by one on each side
    rows = [torch.stack([
        torch.einsum("bhiw,bhow->io", ap[:, dy:dy + H, :, dx:dx + W], g)
        for dx in range(3)]) for dy in range(3)]
    return torch.stack(rows)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _need(x: torch.Tensor, name: str, t: torch.Tensor, dtype, shape=None):
    if t.dtype != dtype or not t.is_contiguous():
        raise TypeError(f"{name} must be contiguous {dtype}, got {t.dtype}")
    if t.device != x.device:
        raise ValueError(f"{name} on {t.device}, x on {x.device}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got "
                         f"{tuple(t.shape)}")


def _stream(x: torch.Tensor):
    return torch.cuda.current_stream(x.device).cuda_stream


# ------------------------------------------- forward / dgrad kernel's plan
CONV_KB = 64  # input channels per K-step: one 128-byte swizzled box row


@dataclass(frozen=True)
class ConvPlan:
    """Geometry of one csrc/conv3x3_bhcw.cu call. The prologue writes a'
    (B, H, Wq, Cp), channels innermost: ingest(x) transposed, or at stride
    2 phase-packed (a'[b, h, u, f*Ci + ci] = ingest(x)[b, h, ci, 2u + f]).
    The GEMM runs a stride-1 conv of a' with the packed weight (taps, Co,
    Cp) over tiles (pixel tile, Co tile, b*H + h), each block walking
    tiles blockIdx, blockIdx + grid, ...; a tile's K-steps go over the
    taps and, per tap, 64-channel blocks. It reads a' through the tensor
    map (Ce, Wq, H, B) and the weight through (Ce, Co, taps, 1), both at
    pitch Cp with the true channel count Ce as extent, so the pad channels
    are never read. The kernel computes the same K-step decode and box
    coordinates from (dx0, kc, kc2); the CPU tests run this plan through a
    torch emulation of the kernel's tile loop."""
    B: int
    H: int
    Ci: int
    W: int
    Co: int
    stride: int
    Ce: int        # the GEMM's input channels: Ci, or 2*Ci at stride 2
    Wq: int        # width of a' and of the output: W, or W/2
    Cp: int        # channel pitch of a' and of the packed weight: Ce to 8
    dx0: int       # first tap column: 0, or 1 at stride 2 (column 0 is 0)
    kc: int        # 64-channel blocks of a tap
    kc2: int       # blocks of tap column 2 (stride 2: the even phase only)
    bm: int        # output channels of a tile (64 per consumer warpgroup)
    bn: int        # pixels of a tile
    nwt: int       # pixel tiles per row
    co_tiles: int
    ksteps: int
    part_rows: int  # rows of the per-tile sums, B * H * nwt

    @property
    def taps(self) -> int:
        return 3 * (3 - self.dx0)

    @property
    def ntiles(self) -> int:
        return self.nwt * self.co_tiles * self.B * self.H

    def tile_origin(self, tile: int) -> Tuple[int, int, int]:
        """(pixel tile, Co tile, b*H + h) of a tile; pixel tiles vary
        fastest."""
        r, wt = divmod(tile, self.nwt)
        bh, ct = divmod(r, self.co_tiles)
        return wt, ct, bh

    def k_step(self, k: int) -> Tuple[int, int, int, int]:
        """(dy, dx, channel block, packed-weight tap) of K-step k: per tap
        row dy, the columns dx0..1 take kc blocks each, then column 2
        takes kc2."""
        lead = (2 - self.dx0) * self.kc
        dy, r = divmod(k, lead + self.kc2)
        if r < lead:
            dx, cb = self.dx0 + r // self.kc, r % self.kc
        else:
            dx, cb = 2, r - lead
        return dy, dx, cb, dy * (3 - self.dx0) + dx - self.dx0

    def w_box(self, k: int, co0: int) -> Tuple[int, int, int, int]:
        """TMA coordinates (ci, co, tap, 0), innermost first, of K-step k's
        weight box: 64 channels x bm output channels."""
        _, _, cb, tap = self.k_step(k)
        return cb * CONV_KB, co0, tap, 0

    def a_box(self, k: int, b: int, h: int, u0: int
              ) -> Tuple[int, int, int, int]:
        """TMA coordinates (ci, u, h, b) of K-step k's activation box for
        the tile at row (b, h) and pixels u0 .. u0+bn-1: 64 channels x bn
        pixels of a' row h+dy-1 from column u0+dx-1. Both shifts fall on
        outer dimensions; an innermost coordinate must start on 16 bytes."""
        dy, dx, cb, _ = self.k_step(k)
        return cb * CONV_KB, u0 + dx - 1, h + dy - 1, b

    def warpgroups(self):
        """(first Co row, first pixel, pixels) of each consumer warpgroup's
        part of a tile, in warpgroup order."""
        wg_m = self.bm // 64
        wn = self.bn // (2 // wg_m)
        return [((g % wg_m) * 64, (g // wg_m) * wn, wn) for g in range(2)]


def plan_conv(B: int, H: int, Ci: int, W: int, Co: int, stride: int = 1
              ) -> ConvPlan:
    """Plan the forward/dgrad kernel for x (B, H, Ci, W) and Co outputs.
    Tiles: 128 Co x 256 pixels where Co > 64 and the row has >= 512
    pixels, 128 x 128 on narrower rows, 64 x 256 at Co <= 64
    (csrc/conv3x3_bhcw.cu says why)."""
    phase = stride == 2
    Ce = 2 * Ci if phase else Ci
    Wq = W // 2 if phase else W
    bm = 128 if Co > 64 else 64
    bn = 256 if bm == 64 or Wq >= 512 else 128
    kc = -(-Ce // CONV_KB)
    kc2 = -(-Ci // CONV_KB) if phase else kc
    dx0 = 1 if phase else 0
    nwt = -(-Wq // bn)
    return ConvPlan(
        B=B, H=H, Ci=Ci, W=W, Co=Co, stride=stride, Ce=Ce, Wq=Wq,
        Cp=-(-Ce // 8) * 8, dx0=dx0, kc=kc, kc2=kc2, bm=bm, bn=bn, nwt=nwt,
        co_tiles=-(-Co // bm), ksteps=3 * ((2 - dx0) * kc + kc2),
        part_rows=B * H * nwt)


def pack_weight(w: torch.Tensor, plan: ConvPlan, flip: bool = False
                ) -> torch.Tensor:
    """(3, 3, Ci, Co) -> the kernel's (taps, Co, Cp): tap dy*3 + dx at
    stride 1; at stride 2 the phase-packed weight (phase_pack) without its
    zero column dx=0, tap dy*2 + dx-1. Channels >= Ce are 0. With ``flip``
    it packs flip_weight(w) (w is then (3, 3, Co, Ci)), the dgrad's."""
    if flip:
        if plan.stride != 1:
            raise ValueError("the dgrad runs at stride 1")
        wt = w.flip(0, 1)  # (3, 3, Co, Ci) of the flipped weight
    else:
        wt = w.permute(0, 1, 3, 2)
    Co, Ci = wt.shape[2], wt.shape[3]
    if plan.stride == 1 and plan.Cp == Ci:  # one copy, no padding
        return wt.reshape(plan.taps, Co, Ci).contiguous()
    wp = w.new_zeros((3, 3 - plan.dx0, Co, plan.Cp))
    if plan.stride == 1:
        wp[..., :Ci] = wt
    else:
        wp[:, 0, :, :Ci] = wt[:, 0]
        wp[:, 0, :, Ci:2 * Ci] = wt[:, 1]
        wp[:, 1, :, :Ci] = wt[:, 2]
    return wp.reshape(plan.taps, Co, plan.Cp)


def _launch_fwd(x, w, scale=None, bias=None, stride_w=1, stats=False,
                cot=None, affine=None, flip=False):
    """One call of csrc/conv3x3_bhcw.cu: the prologue, the GEMM and, when
    sums are asked for, the reducing pass, with the weight w, or with
    ``flip`` flip_weight(w) (the dgrad's). Returns y, or (y, sum0, sum1)."""
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(
            f"the kernel takes bf16 x and w, got {x.dtype} and {w.dtype}"
        )
    _need(x, "x", x, torch.bfloat16)
    if w.device != x.device:
        raise ValueError(f"w on {w.device}, x on {x.device}")
    B, H, Ci, W = x.shape
    Co = w.shape[2 if flip else 3]
    if B * H > 65535:
        raise ValueError(f"B*H={B * H} exceeds the kernel's grid")
    if stride_w == 2 and Ci % 8:
        raise ValueError(f"stride 2 needs Ci % 8 == 0 (whole 16-byte phase "
                         f"halves), got Ci={Ci}")
    if scale is not None:
        if cot is not None:
            raise ValueError("the kernel takes one ingest: affine or cot")
        _need(x, "scale", scale, torch.float32, (Ci,))
        _need(x, "bias", bias, torch.float32, (Ci,))
    cy = c1 = c2 = bx = bs = bb = None
    if cot is not None:
        cy, c1, c2 = cot
        _need(x, "cot y", cy, torch.bfloat16, x.shape)
        _need(x, "gs1", c1, torch.float32, (Ci,))
        _need(x, "gs2", c2, torch.float32, (Ci,))
    if affine is not None:
        if stride_w != 1:
            raise ValueError("the backward epilogue runs at stride 1")
        bx, bs, bb = affine
        _need(x, "affine x", bx, torch.bfloat16, (B, H, Co, W))
        _need(x, "affine scale", bs, torch.float32, (Co,))
        _need(x, "affine bias", bb, torch.float32, (Co,))
    plan = plan_conv(B, H, Ci, W, Co, stride_w)
    wp = pack_weight(w, plan, flip)
    y = torch.empty((B, H, Co, plan.Wq), dtype=x.dtype, device=x.device)
    sums_wanted = stats or affine is not None
    # one scratch buffer, 256-byte-aligned pieces: a', the per-block sums
    sizes = [2 * B * H * plan.Wq * plan.Cp,
             4 * plan.part_rows * 2 * Co if sums_wanted else 0]
    sizes = [-(-n // 256) * 256 for n in sizes]
    buf = torch.empty(sum(sizes), dtype=torch.uint8, device=x.device)
    a_buf = buf.data_ptr()
    part = sums = None
    if sums_wanted:
        part = a_buf + sizes[0]
        sums = torch.empty((2, Co), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _build.load().conv3x3_bhcw_fwd(
            x.data_ptr(), wp.data_ptr(), _ptr(scale), _ptr(bias),
            _ptr(cy), _ptr(c1), _ptr(c2), _ptr(bx), _ptr(bs), _ptr(bb),
            y.data_ptr(), a_buf, part, _ptr(sums), B, H, Ci, W, Co,
            stride_w, plan.Ce, plan.Wq, plan.Cp, plan.dx0, plan.kc,
            plan.kc2, plan.bm, plan.bn, _sm_count(x.device), _stream(x),
        )
    if err != 0:
        raise RuntimeError(f"conv3x3_bhcw_fwd launch failed: error {err}")
    if sums is None:
        return y
    return y, sums[0], sums[1]


def _route(x: torch.Tensor, kernel: str = "conv3x3") -> bool:
    """True: launch the kernel; False: the plain version (CPU tensor)."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"no {kernel} kernel for device {x.device}")
    return True


def conv3x3_bhcw(
    x: torch.Tensor,
    w: torch.Tensor,
    scale: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    stride_w: int = 1,
    stats: bool = False,
):
    """y = conv3x3(x or relu(x*scale + bias), w): (B, H, Ci, W) x
    (3, 3, Ci, Co) -> (B, H, Co, W // stride_w); with ``stats`` returns
    (y, sum y, sum y^2) per output channel. No gradient: see conv3x3."""
    global LAUNCHES
    _check(x, w, scale, bias, stride_w)
    if not _route(x):
        return conv3x3_bhcw_plain(x, w, scale, bias, stride_w, stats)
    out = _launch_fwd(x, w, scale, bias, stride_w, stats)
    LAUNCHES += 1
    return out


def conv3x3_dgrad(gy: torch.Tensor, w: torch.Tensor,
                  cot: Optional[Cot] = None,
                  affine: Optional[Affine] = None):
    """Data gradient of the stride-1 conv with weight w (3, 3, Ci, Co):
    gy (B, H, Co, W) -> dx (B, H, Ci, W), or (dx, dscale, dbias) with
    ``affine``. See conv3x3_dgrad_plain."""
    global DGRAD_LAUNCHES
    _check(gy, w.transpose(2, 3), None, None, 1)  # the flipped shape
    if not _route(gy):
        return conv3x3_dgrad_plain(gy, w, cot, affine)
    out = _launch_fwd(gy, w, cot=cot, affine=affine, flip=True)
    DGRAD_LAUNCHES += 1
    return out


# --------------------------------------------------- wgrad kernel's plan
WGRAD_BOX_W = 64  # pixels per TMA box and pipeline stage (the GEMM's K)
WGRAD_TILE = 64   # input and output channels of a block (wgmma M and N)


@dataclass(frozen=True)
class WgradPlan:
    """Geometry of one csrc/conv3x3_wgrad.cu launch. The GEMM reads a'
    (B, H, Ci, W) at row pitch Wp through the tensor map (W, Ci, H, B) and
    g' transposed, (B, H, W, Cp), through the map (Cp, W, H, B). The kernel
    computes the same chunk decode, box coordinates and split ranges from
    (nwc, chunks, splits); the CPU tests run this plan through a torch
    emulation of the kernel's tile loop."""
    B: int
    H: int
    Ci: int
    W: int
    Co: int
    Wp: int       # row pitch of a', W rounded up to 8 (16-byte strides)
    Cp: int       # channel pitch of g', Co rounded up to 64 (zeros)
    copy_a: bool  # a' = ingest(x) written by the prologue (else x itself)
    nwc: int      # 64-pixel chunks per image row
    chunks: int   # B * H * nwc, in (b, h, w0) row-major order
    ci_tiles: int
    co_tiles: int
    splits: int   # S blocks share each (ci, co) tile's chunks

    def split_range(self, s: int) -> Tuple[int, int]:
        """The contiguous chunks [begin, end) of split s."""
        return (self.chunks * s // self.splits,
                self.chunks * (s + 1) // self.splits)

    def chunk_origin(self, c: int) -> Tuple[int, int, int]:
        """(b, h, w0) of chunk c."""
        bh, wc = divmod(c, self.nwc)
        b, h = divmod(bh, self.H)
        return b, h, wc * WGRAD_BOX_W

    def a_box(self, c: int, dy: int, ci0: int) -> Tuple[int, int, int, int]:
        """TMA coordinates (w, ci, h, b), innermost first, of the A box of
        tap row dy: row h+dy-1 of a', columns w0 .. w0+63."""
        b, h, w0 = self.chunk_origin(c)
        return w0, ci0, h + dy - 1, b

    def g_box(self, c: int, dx: int, co0: int) -> Tuple[int, int, int, int]:
        """TMA coordinates (co, w, h, b) of the G box of tap column dx: row
        h of g', columns w0-dx+1 .. w0-dx+64. The one-pixel shift falls on
        an outer dimension of the map; an innermost coordinate must start
        on 16 bytes."""
        b, h, w0 = self.chunk_origin(c)
        return co0, w0 - dx + 1, h, b


def plan_wgrad(B: int, H: int, Ci: int, W: int, Co: int, ingest: bool,
               aligned: bool = True, sms: int = 132) -> WgradPlan:
    """Plan the weight-gradient kernel for x (B, H, Ci, W) and gy (B, H,
    Co, W). x is read in place when it needs no ingest, its rows are whole
    16-byte units (W % 8 == 0) and its base is 16-byte aligned
    (``aligned``); otherwise the prologue writes a' at pitch Wp. g' is
    always written, transposed. S is the number of blocks per (ci, co)
    tile that fills ``sms`` SMs in one wave, at most one per chunk."""
    nwc = -(-W // WGRAD_BOX_W)
    chunks = B * H * nwc
    ci_tiles = -(-Ci // WGRAD_TILE)
    co_tiles = -(-Co // WGRAD_TILE)
    return WgradPlan(
        B=B, H=H, Ci=Ci, W=W, Co=Co, Wp=-(-W // 8) * 8,
        Cp=co_tiles * WGRAD_TILE,
        copy_a=ingest or W % 8 != 0 or not aligned,
        nwc=nwc, chunks=chunks, ci_tiles=ci_tiles, co_tiles=co_tiles,
        splits=max(1, min(chunks, sms // (ci_tiles * co_tiles))))


_SMS = {}


def _sm_count(dev: torch.device) -> int:
    if dev not in _SMS:
        _SMS[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    return _SMS[dev]


def conv3x3_wgrad(x: torch.Tensor, gy: torch.Tensor,
                  scale: Optional[torch.Tensor] = None,
                  bias: Optional[torch.Tensor] = None,
                  cot: Optional[Cot] = None) -> torch.Tensor:
    """Weight gradient of the stride-1 conv: x (B, H, Ci, W), gy
    (B, H, Co, W) -> f32 (3, 3, Ci, Co). See conv3x3_wgrad_plain."""
    global WGRAD_LAUNCHES
    B, H, Ci, W = x.shape
    Co = gy.shape[2]
    if tuple(gy.shape) != (B, H, Co, W):
        raise ValueError(f"gy {tuple(gy.shape)} does not match x "
                         f"{tuple(x.shape)}")
    if not _route(x):
        return conv3x3_wgrad_plain(x, gy, scale, bias, cot)
    for name, t in (("x", x), ("gy", gy)):
        _need(x, name, t, torch.bfloat16)
    if scale is not None:
        _need(x, "scale", scale, torch.float32, (Ci,))
        _need(x, "bias", bias, torch.float32, (Ci,))
    if cot is not None:
        _need(x, "cot y", cot[0], torch.bfloat16, gy.shape)
        _need(x, "gs1", cot[1], torch.float32, (Co,))
        _need(x, "gs2", cot[2], torch.float32, (Co,))
    plan = plan_wgrad(B, H, Ci, W, Co, scale is not None,
                      x.data_ptr() % 16 == 0, _sm_count(x.device))
    # one scratch buffer, 256-byte-aligned pieces: a' (none when x is read
    # in place), g', the f32 partials
    sizes = [2 * B * H * Ci * plan.Wp if plan.copy_a else 0,
             2 * B * H * W * plan.Cp, 4 * plan.splits * 9 * Ci * Co]
    sizes = [-(-n // 256) * 256 for n in sizes]
    buf = torch.empty(sum(sizes), dtype=torch.uint8, device=x.device)
    a_buf = buf.data_ptr()
    g_buf = a_buf + sizes[0]
    part = g_buf + sizes[1]
    y, g1, g2 = cot if cot is not None else (None, None, None)
    dw = torch.empty((3, 3, Ci, Co), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _build.load().conv3x3_wgrad(
            x.data_ptr(), gy.data_ptr(), _ptr(scale), _ptr(bias), _ptr(y),
            _ptr(g1), _ptr(g2), a_buf if plan.copy_a else None, g_buf, part,
            dw.data_ptr(), B, H, Ci, W, Co, plan.Wp, plan.Cp, plan.nwc,
            plan.chunks, plan.splits, _stream(x))
    if err != 0:
        raise RuntimeError(f"conv3x3_wgrad launch failed: error {err}")
    WGRAD_LAUNCHES += 1
    return dw


# ------------------------------------------------------------- autograd
def phase_pack(x: torch.Tensor, w: torch.Tensor):
    """Stride-2 phase identity: the stride-2 conv of x with w equals the
    stride-1 conv of x2 = [x_even; x_odd] (channels) with the packed
    kp[:, 1] = [w[:, 0]; w[:, 1]], kp[:, 2] = [w[:, 2]; 0], kp[:, 0] = 0."""
    Ci = x.shape[2]
    x2 = torch.cat([x[..., 0::2], x[..., 1::2]], dim=2).contiguous()
    kp = w.new_zeros((3, 3, 2 * Ci, w.shape[3]))
    kp[:, 1, :Ci] = w[:, 0]
    kp[:, 1, Ci:] = w[:, 1]
    kp[:, 2, :Ci] = w[:, 2]
    return x2, kp


def phase_unpack_weight(dkp: torch.Tensor, Ci: int) -> torch.Tensor:
    """Gradient of phase_pack's kp -> gradient of w."""
    return torch.stack([dkp[:, 1, :Ci], dkp[:, 1, Ci:], dkp[:, 2, :Ci]],
                       dim=1)


class _Conv3x3Fn(torch.autograd.Function):
    """y = conv3x3(x or relu(x*scale + bias), w, stride) [, sum y, sum y^2]
    with the backward of conv_pallas.py's four custom VJPs: dgrad (cot
    fold on load, affine-backward epilogue) and wgrad (ingest, cot)."""

    @staticmethod
    def forward(ctx, x, w, scale, bias, stride_w, stats):
        out = conv3x3_bhcw(x, w, scale, bias, stride_w, stats)
        y = out[0] if stats else out
        ctx.save_for_backward(x, w, scale, bias, y if stats else None)
        ctx.stride_w, ctx.stats = stride_w, stats
        return out

    @staticmethod
    def backward(ctx, gy, gs1=None, gs2=None):
        x, w, scale, bias, y = ctx.saved_tensors
        need_x, need_w, need_s, need_b = ctx.needs_input_grad[:4]
        gy = gy.contiguous()
        cot = (y, gs1.float().contiguous(), gs2.float().contiguous()) \
            if ctx.stats else None
        ingest = scale is not None
        Ci = x.shape[2]
        xs, ws, ss, bs = x, w, scale, bias
        if ctx.stride_w == 2:
            xs, ws = phase_pack(x, w)
            if ingest:
                ss, bs = torch.cat([scale, scale]), torch.cat([bias, bias])
        dx = dw = dscale = dbias = None
        if need_x or need_s or need_b:  # skipped for the data's first conv
            if ingest:
                dx, dscale, dbias = conv3x3_dgrad(gy, ws, cot, (xs, ss, bs))
            else:
                dx = conv3x3_dgrad(gy, ws, cot)
            if ctx.stride_w == 2:
                B, H, _, W2 = dx.shape
                dx = torch.stack([dx[:, :, :Ci], dx[:, :, Ci:]], dim=-1)
                dx = dx.reshape(B, H, Ci, 2 * W2)
                if ingest:
                    dscale = dscale[:Ci] + dscale[Ci:]
                    dbias = dbias[:Ci] + dbias[Ci:]
        if need_w:
            dw = conv3x3_wgrad(xs, gy, ss, bs, cot)
            if ctx.stride_w == 2:
                dw = phase_unpack_weight(dw, Ci)
            dw = dw.to(w.dtype)
        return dx, dw, dscale, dbias, None, None


def conv3x3(x: torch.Tensor, w: torch.Tensor,
            scale: Optional[torch.Tensor] = None,
            bias: Optional[torch.Tensor] = None,
            stride_w: int = 1, stats: bool = False):
    """Differentiable conv3x3_bhcw: gradients flow to x, w, scale and bias
    and, with ``stats``, from the sums back into the conv (the BatchNorm
    statistics backward)."""
    tensors = [t for t in (x, w, scale, bias) if t is not None]
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _Conv3x3Fn.apply(x, w, scale, bias, stride_w, stats)
    return conv3x3_bhcw(x, w, scale, bias, stride_w, stats)
