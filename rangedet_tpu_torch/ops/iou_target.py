"""IoU-aware classification target: the hand-written Hopper kernels
(``csrc/iou_target.cu``: the candidate prep and the clip), their wrappers,
and the plain version. Counterpart of
``rangedet_tpu/ops/iou_target_pallas.py:iou_target_fused`` (skip mode
"gate8") with its XLA prep; the target is consumed under stop-gradient, so
the op runs under ``torch.no_grad`` and returns a tensor without history.

Candidate contract (the TPU kernel's, kept so the port equals JAX
everywhere, crowded blocks included): pixels are flattened column-major and
cut into 2048-pixel blocks; per block the G = min(topk_gt, M) GT rows are
ordered by circumcircle clearance (block-min center distance - block-max
predicted circumradius - GT circumradius; zero-area rows +inf), index as
tie-break, and only the first nv = min(#(clearance <= 0), G) can overlap a
pixel of the block. The clip loop runs over ceil(nv/8)*8 of them (padded
to a multiple of 8 with zero-area rows). When more than G GTs overlap a
block the result is a one-sided lower bound of the dense max IoU, as in
JAX.

* ``iou_target`` routes: a CPU tensor to the plain version, a CUDA tensor
  to the kernels or raises, three launches a call. ``candidates`` (the
  prep kernel) computes the per-GT quantities, reads the deltas and points
  through their strides, so class k's slice of the head's (B, H, W, K*8)
  tensor is read in place, and writes the candidate table, nv and the
  zeroed output; ``clip`` (the clip kernel and its clean pass) fills the
  (B, H, W) output.
* ``prepare_candidates`` + ``iou_target_plain_blocks`` are the plain
  version: the prep in torch ops (the XLA prep's), blocked planar copies
  of the pixels, and the clip as one loop over each block's candidates.
  The kernels compute the same operations, with one freedom: the prep
  kernel adds the four terms of a GT's shoelace area and centre in corner
  order, where ``polygon_area`` and ``mean`` leave the order to torch's
  reduction. On the CPU the two agree bit for bit; on the card a
  candidate row's area can differ from the plain prep's by an ulp.
"""
from __future__ import annotations

import ctypes
from typing import List, Tuple

import torch
from torch.profiler import record_function

from .. import _build
from .boxes import polygon_area

LAUNCHES = 0       # clip launches (the clip kernel and its clean pass)
PREP_LAUNCHES = 0  # candidate prep launches

EPS = 1e-8
TILE = 2048
THREADS = 256  # threads of a kernel block
# the clip's schedule: sub-tiles of TILE // SUBS pixels a 2048-pixel block
# (one pixel a thread) and CHUNK candidates a kernel block
SUBS = 8
CHUNK = 8
# the prep keeps 2 x TILE centres and 13 floats a GT in shared memory
MAX_GT = 4096
_REVERSE = [0, 3, 2, 1]


def reset_counts() -> None:
    global LAUNCHES, PREP_LAUNCHES
    LAUNCHES = PREP_LAUNCHES = 0


def local_index(j):
    """The block-local pixel of the kernels' thread slot j: the transpose of
    a 64 x 32 grid, a bijection of [0, TILE). At H = 64 a warp's 32 lanes
    take one row of 32 neighbouring columns."""
    return (j % 32) * 64 + j // 32


def prepare_candidates(deltas: torch.Tensor, pc: torch.Tensor,
                       gt_corners: torch.Tensor, topk_gt: int):
    """deltas (B, H, W, 8), pc (B, H, W, 3), gt_corners (B, M, 4, 2) ->
    (cand (B*nb, Gk, 9) [4 CCW corners, |area|], nv (B*nb,) int32,
    deltas (B*nb, 8, TILE), pc (B*nb, 3, TILE)), all f32 but nv; the pixel
    planes are column-major and zero-padded to nb*TILE pixels."""
    B, H, W, _ = deltas.shape
    N = H * W
    M = gt_corners.shape[1]
    G = min(topk_gt, M) if topk_gt else M
    d = deltas.float().transpose(1, 2).reshape(B, N, 8)
    p = pc.float().transpose(1, 2).reshape(B, N, 3)
    gt = gt_corners.float()
    gt_ccw = torch.where((polygon_area(gt) < 0)[..., None, None],
                         gt[..., _REVERSE, :], gt)
    gt_area = polygon_area(gt_ccw).abs()  # (B, M)

    # decoded centers, for the block-level candidate choice
    rxy = torch.sqrt(p[..., 0] ** 2 + p[..., 1] ** 2)
    safe = rxy.clamp(min=EPS)
    cos_a = torch.where(rxy > EPS, p[..., 0] / safe, torch.ones_like(rxy))
    sin_a = torch.where(rxy > EPS, p[..., 1] / safe, torch.zeros_like(rxy))
    ddx = d[..., 0] * d[..., 0].abs()
    ddy = d[..., 1] * d[..., 1].abs()
    cx = p[..., 0] + ddx * cos_a - ddy * sin_a
    cy = p[..., 1] + ddx * sin_a + ddy * cos_a

    nb = -(-N // TILE)
    padN = nb * TILE - N
    gc = gt_ccw.mean(dim=-2)  # (B, M, 2)
    d2 = ((cx[..., None] - gc[:, None, :, 0]) ** 2
          + (cy[..., None] - gc[:, None, :, 1]) ** 2)  # (B, N, M)
    d2 = torch.nn.functional.pad(d2, (0, 0, 0, padN), value=float("inf"))
    block_min = d2.reshape(B, nb, TILE, M).amin(dim=2)  # (B, nb, M)
    r_pred = 0.5 * torch.sqrt(torch.exp(d[..., 2]) ** 2
                              + torch.exp(d[..., 3]) ** 2)
    rp_max = torch.nn.functional.pad(r_pred, (0, padN)).reshape(
        B, nb, TILE).amax(dim=2)
    r_gt = torch.sqrt(((gt_ccw - gc[:, :, None, :]) ** 2).sum(-1).amax(-1))
    clearance = (torch.sqrt(block_min) - rp_max[..., None]
                 - r_gt[:, None, :])  # (B, nb, M)
    clearance = torch.where(gt_area[:, None, :] < EPS,
                            torch.full_like(clearance, float("inf")),
                            clearance)
    order = torch.sort(clearance, dim=-1, stable=True).indices[..., :G]
    nv = (clearance <= 0.0).sum(-1).clamp(max=G).to(torch.int32)

    gt9 = torch.cat([gt_ccw.reshape(B, M, 8), gt_area[..., None]], dim=-1)
    cand = torch.gather(gt9, 1, order.reshape(B, nb * G, 1).expand(-1, -1, 9))
    cand = cand.reshape(B * nb, G, 9)
    Gk = -(-G // 8) * 8
    if Gk != G:
        cand = torch.nn.functional.pad(cand, (0, 0, 0, Gk - G))

    def planar(x, C):
        x = torch.nn.functional.pad(x, (0, 0, 0, padN))
        return x.reshape(B * nb, TILE, C).transpose(1, 2).contiguous()

    return (cand.contiguous(), nv.reshape(B * nb).contiguous(),
            planar(d, 8), planar(p, 3))


def _decode_corners(d: torch.Tensor, p: torch.Tensor):
    """Trig-free decode of the kernel: d (..., 8, T), p (..., 3, T) ->
    CCW corner lists ax, ay (4 tensors each) and the area l*w."""
    pcx, pcy = p[:, 0], p[:, 1]
    r = torch.sqrt(pcx * pcx + pcy * pcy)
    big = r > EPS
    safe_r = torch.where(big, r, torch.ones_like(r))
    cos_a = torch.where(big, pcx / safe_r, torch.ones_like(r))
    sin_a = torch.where(big, pcy / safe_r, torch.zeros_like(r))
    dx = d[:, 0] * d[:, 0].abs()
    dy = d[:, 1] * d[:, 1].abs()
    width = torch.exp(d[:, 2])
    length = torch.exp(d[:, 3])
    cx = pcx + dx * cos_a - dy * sin_a
    cy = pcy + dx * sin_a + dy * cos_a
    n = torch.sqrt(d[:, 4] * d[:, 4] + d[:, 5] * d[:, 5])
    bn = n > EPS
    safe_n = torch.where(bn, n, torch.ones_like(n))
    cos_rel = torch.where(bn, d[:, 4] / safe_n, torch.ones_like(n))
    sin_rel = torch.where(bn, d[:, 5] / safe_n, torch.zeros_like(n))
    cyw = cos_rel * cos_a - sin_rel * sin_a
    sy = sin_rel * cos_a + cos_rel * sin_a
    hl, hw = 0.5 * length, 0.5 * width
    # CCW corners: D(+l,+w) C(-l,+w) B(-l,-w) A(+l,-w)
    lx = [hl, -hl, -hl, hl]
    wy = [hw, hw, -hw, -hw]
    ax = [lx[i] * cyw - wy[i] * sy + cx for i in range(4)]
    ay = [lx[i] * sy + wy[i] * cyw + cy for i in range(4)]
    return ax, ay, length * width


def _pieces(px: List[torch.Tensor], py: List[torch.Tensor],
            qx: List[torch.Tensor], qy: List[torch.Tensor]) -> torch.Tensor:
    """Sum of cross(s0, s1) over the parts of P's edges inside Q
    (_green_inter_scalar_gt); every entry broadcasts to (blocks, TILE)."""
    f = [[(qx[(j + 1) % 4] - qx[j]) * (py[i] - qy[j])
          - (qy[(j + 1) % 4] - qy[j]) * (px[i] - qx[j]) for i in range(4)]
         for j in range(4)]
    total = 0.0
    for i in range(4):
        i1 = (i + 1) % 4
        t0 = torch.zeros_like(f[0][0])
        t1 = torch.ones_like(t0)
        empty = torch.zeros_like(t0, dtype=torch.bool)
        for j in range(4):
            f0, f1 = f[j][i], f[j][i1]
            denom = f0 - f1
            t_star = f0 / torch.where(denom.abs() > EPS, denom,
                                      torch.ones_like(denom))
            empty = empty | ((f0 < 0) & (f1 < 0))
            t0 = torch.maximum(t0, torch.where((f0 < 0) & (f1 >= 0), t_star,
                                               torch.zeros_like(t_star)))
            t1 = torch.minimum(t1, torch.where((f0 >= 0) & (f1 < 0), t_star,
                                               torch.ones_like(t_star)))
        empty = empty | (t1 <= t0)
        dx = px[i1] - px[i]
        dy = py[i1] - py[i]
        s0x, s0y = px[i] + t0 * dx, py[i] + t0 * dy
        s1x, s1y = px[i] + t1 * dx, py[i] + t1 * dy
        contrib = s0x * s1y - s0y * s1x
        total = total + torch.where(empty, torch.zeros_like(contrib), contrib)
    return total


def iou_target_plain_blocks(cand, nv, deltas, pc) -> torch.Tensor:
    """The kernel's function in torch, on prepare_candidates' output ->
    (blocks, TILE) f32: per pixel the max IoU over its block's first
    ceil(nv/8)*8 candidates, cleaned to [0, 1]."""
    Gk = cand.shape[1]
    ax, ay, sa = _decode_corners(deltas, pc)
    n = ((nv.long() + 7) // 8 * 8).clamp(max=Gk)  # (blocks,)
    best = torch.zeros_like(sa)
    for k in range(Gk):
        live = (k < n)[:, None]
        if not bool(live.any()):
            break
        row = cand[:, k, :, None]  # (blocks, 9, 1)
        gx = [row[:, 2 * i] for i in range(4)]
        gy = [row[:, 2 * i + 1] for i in range(4)]
        sb = row[:, 8]
        inter = torch.clamp_min(_pieces(ax, ay, gx, gy)
                                + _pieces(gx, gy, ax, ay), 0.0) * 0.5
        one = inter / torch.clamp_min(sa + sb - inter, EPS)
        one = torch.where((sa < EPS) | (sb < EPS), torch.zeros_like(one), one)
        best = torch.where(live, torch.maximum(best, one), best)
    best = torch.where(torch.isfinite(best), best, torch.zeros_like(best))
    return torch.where((best < 0) | (best > 1), torch.zeros_like(best), best)


def _unblock(out: torch.Tensor, shape: Tuple[int, int, int]) -> torch.Tensor:
    B, H, W = shape
    return out.reshape(B, -1)[:, :H * W].reshape(B, W, H).transpose(1, 2)


def _strides(t: torch.Tensor):
    return (ctypes.c_longlong * 4)(*t.stride())


def _check(deltas, pc, *rest):
    if deltas.dim() != 4 or deltas.shape[-1] < 6:
        raise ValueError(f"deltas must be (B, H, W, >= 6), got "
                         f"{tuple(deltas.shape)}")
    if pc.dim() != 4 or pc.shape[:3] != deltas.shape[:3] or pc.shape[-1] < 2:
        raise ValueError(f"pc {tuple(pc.shape)} does not match deltas "
                         f"{tuple(deltas.shape)}")
    for name, t in (("deltas", deltas), ("pc", pc), *rest):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != deltas.device or t.device.type != "cuda":
            raise ValueError(f"{name} on {t.device}, deltas on "
                             f"{deltas.device}: the kernels need one card")


def candidates(deltas: torch.Tensor, pc: torch.Tensor,
               gt_corners: torch.Tensor, topk_gt: int = 32):
    """The prep kernel on CUDA tensors: deltas (B, H, W, 8) and pc
    (B, H, W, 3), f32 views of any strides, gt_corners (B, M, 4, 2) ->
    (cand (B*nb, Gk, 9), nv (B*nb,) int32, out (B, H, W) f32 zeros): the
    first two are prepare_candidates' but for the order of the per-GT
    sums (the module's docstring)."""
    global PREP_LAUNCHES
    B, H, W, _ = deltas.shape
    M = gt_corners.shape[1]
    if M > MAX_GT:
        raise ValueError(f"{M} GT rows, the prep kernel takes {MAX_GT}")
    gt = gt_corners.contiguous()
    _check(deltas, pc, ("gt_corners", gt))
    if gt.shape != (B, M, 4, 2):
        raise ValueError(f"gt_corners {tuple(gt.shape)}, expected "
                         f"({B}, M, 4, 2)")
    G = min(topk_gt, M) if topk_gt else M
    Gk = -(-G // 8) * 8
    nb = -(-H * W // TILE)
    dev = deltas.device
    cand = torch.empty((B * nb, Gk, 9), dtype=torch.float32, device=dev)
    nv = torch.empty((B * nb,), dtype=torch.int32, device=dev)
    out = torch.empty((B, H, W), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _build.load().iou_prep(
            deltas.data_ptr(), _strides(deltas), pc.data_ptr(), _strides(pc),
            B, H, W, gt.data_ptr(), M, G, Gk, cand.data_ptr(),
            nv.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"iou_prep launch failed: cudaError {err}")
    PREP_LAUNCHES += 1
    return cand, nv, out


def clip(cand: torch.Tensor, nv: torch.Tensor, deltas: torch.Tensor,
         pc: torch.Tensor, out: torch.Tensor, subs: int = SUBS,
         chunk: int = CHUNK) -> torch.Tensor:
    """The clip kernel and its clean pass on CUDA tensors, over
    ``candidates``' cand, nv and zeroed out (filled in place and returned).
    ``subs`` (dividing TILE // THREADS) and ``chunk`` set the schedule
    (``tools/profile_iou.py --schedules`` times others); subs=1, chunk=Gk
    is one kernel block per 2048-pixel block, the first port's grid."""
    global LAUNCHES
    B, H, W, _ = deltas.shape
    Gk = cand.shape[1]
    _check(deltas, pc, ("cand", cand), ("out", out))
    if nv.dtype != torch.int32 or nv.device != deltas.device:
        raise TypeError("nv must be int32 on the deltas' card")
    if not (cand.is_contiguous() and nv.is_contiguous()
            and out.is_contiguous() and out.shape == (B, H, W)):
        raise ValueError("cand, nv and out must be candidates()' outputs")
    if (TILE // THREADS) % subs or chunk < 1:
        raise ValueError(f"no clip schedule subs={subs}, chunk={chunk}")
    dev = deltas.device
    with torch.cuda.device(dev):
        err = _build.load().iou_clip(
            deltas.data_ptr(), _strides(deltas), pc.data_ptr(), _strides(pc),
            B, H, W, cand.data_ptr(), nv.data_ptr(), Gk, subs, chunk,
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"iou_clip launch failed: cudaError {err}")
    LAUNCHES += 1
    return out


@torch.no_grad()
def iou_target(deltas: torch.Tensor, pc: torch.Tensor,
               gt_corners: torch.Tensor, topk_gt: int = 32) -> torch.Tensor:
    """deltas (B, H, W, 8), pc (B, H, W, 3), gt_corners (B, M, 4, 2) ->
    max IoU (B, H, W) f32 under the candidate contract above: the kernels
    on a CUDA tensor, the plain version on a CPU tensor."""
    if deltas.device.type == "cpu":
        return iou_target_plain(deltas, pc, gt_corners, topk_gt)
    if deltas.device.type != "cuda":
        raise ValueError(f"no IoU-target kernel for device {deltas.device}")
    with record_function("iou_target"):
        cand, nv, out = candidates(deltas, pc, gt_corners, topk_gt)
        return clip(cand, nv, deltas, pc, out)


@torch.no_grad()
def iou_target_plain(deltas: torch.Tensor, pc: torch.Tensor,
                     gt_corners: torch.Tensor, topk_gt: int = 32
                     ) -> torch.Tensor:
    """iou_target through the plain version on any device."""
    B, H, W, _ = deltas.shape
    prep = prepare_candidates(deltas, pc, gt_corners, topk_gt)
    return _unblock(iou_target_plain_blocks(*prep), (B, H, W))
