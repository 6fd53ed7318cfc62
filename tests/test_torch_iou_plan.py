"""The IoU-target kernels' schedules on the CPU.

csrc/iou_target.cu (the candidate prep and the chunked clip) runs only on
the card. Here torch emulations of their schedules run on the CPU: the
prep's per-GT stage (the 4-term sums in corner order), its
strided column-major reads through local_index, per block the max
predicted circumradius and, for GTs of nonzero area only, the min squared
centre distance, the clearance, its stable rank with NaN last, the scatter
of the rows of rank < G and the zero rows up to Gk, nv; the clip's
sub-tiles and candidate chunks (a chunk past ceil(nv/8)*8 does nothing),
each chunk's NaN-propagating max from 0, their combine as a max of the
float bits with the sign bit cleared, and the final clean. They must equal
the plain version bit for bit (prepare_candidates' cand and nv,
iou_target_plain_blocks' output) on sparse and crowded scenes, duplicate
GTs (tied keys), frames of padding rows only, and deltas whose exp
overflows (NaN clearances and NaN IoUs).
"""
import numpy as np
import pytest
import torch

from rangedet_tpu_torch.ops import boxes
from rangedet_tpu_torch.ops import iou_target as iou

# one intra-op thread per test process: several workers share the cores
torch.set_num_threads(1)

TILE = iou.TILE
SCENES = ["sparse", "crowded", "duplicates", "padding", "overflow"]


def _scene(name, B=2, H=16, W=300, M=40, seed=5):
    """deltas (B, H, W, 8), pc (B, H, W, 3), gt (B, M, 4, 2) f32: points on
    an azimuth grid, GT boxes near pixels, the last 16 GT rows zero (the
    data's padding). H*W = 4800 pixels, three blocks, the last one short."""
    r = np.random.RandomState(seed + SCENES.index(name))
    az = np.linspace(-np.pi, np.pi, W, endpoint=False)
    rad = r.uniform(3.0, 40.0, size=(B, H, W))
    pc = np.stack([rad * np.cos(az)[None, None], rad * np.sin(az)[None, None],
                   r.uniform(-1, 1, size=(B, H, W))], -1).astype(np.float32)
    deltas = (r.randn(B, H, W, 8) * 0.3).astype(np.float32)
    n = M - 16
    if name == "crowded":  # more than G = 32 live candidates in a block
        n = M
        ctr = pc[:, 4, 37, None, :2] + r.uniform(-2, 2, (B, n, 2))
    else:
        idx = r.randint(0, H * W, size=(B, n))
        ctr = pc.reshape(B, -1, 3)[np.arange(B)[:, None], idx][..., :2]
    lw = r.uniform(2.0, 6.0, size=(B, n, 2))
    yaw = r.uniform(-np.pi, np.pi, size=(B, n))
    c, s = np.cos(yaw), np.sin(yaw)
    lx = np.stack([1, -1, -1, 1], -1) * lw[..., :1] / 2
    wy = np.stack([1, 1, -1, -1], -1) * lw[..., 1:] / 2
    boxes = np.stack([ctr[..., :1] + lx * c[..., None] - wy * s[..., None],
                      ctr[..., 1:2] + lx * s[..., None] + wy * c[..., None]],
                     -1)
    boxes[:, ::3] = boxes[:, ::3, ::-1]  # some clockwise
    gt = np.zeros((B, M, 4, 2), np.float32)
    gt[:, :n] = boxes
    if name == "duplicates":  # equal clearance keys, in and out of G
        gt[:, 8:16] = gt[:, 0:8]
        gt[:, 20:24] = gt[:, 3:4]
    if name == "padding":  # a frame without a box
        gt[1] = 0.0
    if name == "overflow":
        # block 1 of frame 0: d*|d| and exp overflow, so its centres and
        # circumradius are inf or NaN and every clearance of a real GT is
        # NaN; a few NaN-making pixels in frame 1 as well
        n0 = np.arange(TILE, 2 * TILE)
        deltas[0, n0 % H, n0 // H, 0] = 1e20
        deltas[0, n0 % H, n0 // H, 2] = 100.0
        deltas[1, 3, 17, 2:4] = 100.0
        deltas[1, 5, 40, 4:6] = 0.0
    return (torch.from_numpy(deltas), torch.from_numpy(pc),
            torch.from_numpy(gt))


def _read(t, b, h, w, c):
    """Element (b, h, w, c) of a (B, H, W, C) view read as the kernels read
    it: its storage at the view's offset and four strides."""
    sb, sh, sw, sc = t.stride()
    flat = t.as_strided((t.untyped_storage().nbytes() // t.element_size(),),
                        (1,), 0)
    return flat[t.storage_offset() + b * sb + h * sh + w * sw + c * sc]


def _pixels(H, W, blk, slots):
    """The valid slots of a block: (slot j, local pixel li, h, w)."""
    li = iou.local_index(slots)
    keep = li < min(TILE, H * W - blk * TILE)
    n = blk * TILE + li[keep]
    return slots[keep], li[keep], n % H, n // H


def _centre(pcx, pcy, d0, d1):
    """The kernels' centre(): the decoded centre and the azimuth's (cos,
    sin), in their order of operations."""
    r = torch.sqrt(pcx * pcx + pcy * pcy)
    big = r > iou.EPS
    safe_r = torch.where(big, r, torch.ones_like(r))
    cos_a = torch.where(big, pcx / safe_r, torch.ones_like(r))
    sin_a = torch.where(big, pcy / safe_r, torch.zeros_like(r))
    dx, dy = d0 * d0.abs(), d1 * d1.abs()
    return (pcx + dx * cos_a - dy * sin_a, pcy + dx * sin_a + dy * cos_a)


def _before(kj, j, ki, i):
    """key_j sorts before key_i: stable ascending, NaN last."""
    nj, ni = torch.isnan(kj), torch.isnan(ki)
    less = torch.where(ni, ~nj, kj < ki)
    same = (nj & ni) | (kj == ki)
    return less | (same & (j < i))


def _gt_stage(gt):
    """The prep kernel's per-GT stage, corner by corner: (B, M, 12)."""
    x = [gt[..., i, 0] for i in range(4)]
    y = [gt[..., i, 1] for i in range(4)]

    def shoelace(x, y):
        c = [x[i] * y[(i + 1) % 4] - x[(i + 1) % 4] * y[i] for i in range(4)]
        return 0.5 * (((c[0] + c[1]) + c[2]) + c[3])

    rev = shoelace(x, y) < 0  # swap corners 1 and 3
    x[1], x[3] = torch.where(rev, x[3], x[1]), torch.where(rev, x[1], x[3])
    y[1], y[3] = torch.where(rev, y[3], y[1]), torch.where(rev, y[1], y[3])
    gx = (((x[0] + x[1]) + x[2]) + x[3]) * 0.25
    gy = (((y[0] + y[1]) + y[2]) + y[3]) * 0.25
    r2 = torch.full_like(gx, -float("inf"))
    for i in range(4):
        dx, dy = x[i] - gx, y[i] - gy
        r2 = torch.maximum(r2, dx * dx + dy * dy)
    corners = [v for i in range(4) for v in (x[i], y[i])]
    return torch.stack(corners + [shoelace(x, y).abs(), gx, gy,
                                  torch.sqrt(r2)], dim=-1)


def emulate_prep(deltas, pc, gt_corners, topk_gt=32):
    """iou_prep_kernel's schedule: one pass per (block, frame)."""
    B, H, W, _ = deltas.shape
    M = gt_corners.shape[1]
    G = min(topk_gt, M) if topk_gt else M
    Gk = -(-G // 8) * 8
    nb = -(-H * W // TILE)
    gtq = _gt_stage(gt_corners)
    cand = torch.full((B * nb, Gk, 9), float("nan"))  # every row written
    nv = torch.full((B * nb,), -1, dtype=torch.int32)
    idx = torch.arange(M)
    for b in range(B):
        for blk in range(nb):
            _, _, h, w = _pixels(H, W, blk, torch.arange(TILE))
            cx, cy = _centre(_read(pc, b, h, w, 0), _read(pc, b, h, w, 1),
                             _read(deltas, b, h, w, 0),
                             _read(deltas, b, h, w, 1))
            wd = torch.exp(_read(deltas, b, h, w, 2))
            ld = torch.exp(_read(deltas, b, h, w, 3))
            rp = torch.cat([torch.zeros(1),
                            0.5 * torch.sqrt(wd * wd + ld * ld)]).amax()
            clr = torch.full((M,), float("inf"))
            live = ~(gtq[b, :, 8] < iou.EPS)  # zero-area rows: +inf as is
            g = gtq[b, live]
            dx = cx[:, None] - g[None, :, 9]
            dy = cy[:, None] - g[None, :, 10]
            bm = torch.cat([torch.full((1, len(g)), float("inf")),
                            dx * dx + dy * dy]).amin(0)
            clr[live] = torch.sqrt(bm) - rp - g[:, 11]
            rank = _before(clr[None, :], idx[None, :], clr[:, None],
                           idx[:, None]).sum(1)
            row = b * nb + blk
            keep = rank < G
            cand[row, rank[keep]] = gtq[b, keep, :9]
            cand[row, G:] = 0.0
            nv[row] = min(int((clr <= 0).sum()), G)
    return cand, nv


def emulate_clip(cand, nv, d, p, subs, chunk):
    """iou_clip_kernel's schedule over prepare_candidates' blocks: per
    (sub-tile, chunk) block the pixels' maxima from 0 over the chunk's
    candidates, combined into the zeroed output as a max of their bits
    without the sign bit; then the clean. Returns (out, all per-pair IoUs
    >= 0 or NaN)."""
    blocks, Gk = cand.shape[:2]
    ax, ay, sa = iou._decode_corners(d, p)
    bits = torch.zeros((blocks, TILE), dtype=torch.int64)
    seen = torch.zeros((blocks, TILE), dtype=torch.int64)
    n8 = ((nv.long() + 7) // 8 * 8).clamp(max=Gk)
    per = TILE // subs
    signed = True
    for sub in range(subs):
        li = iou.local_index(torch.arange(sub * per, (sub + 1) * per))
        seen[:, li] += 1
        for k0 in range(0, Gk, chunk):
            best = torch.zeros((blocks, per))
            ran = k0 < n8  # a block past ceil(nv/8)*8 exits at once
            for k in range(k0, min(k0 + chunk, Gk)):
                row = cand[:, k, :, None]
                gx = [row[:, 2 * i] for i in range(4)]
                gy = [row[:, 2 * i + 1] for i in range(4)]
                px = [a[:, li] for a in ax]
                py = [a[:, li] for a in ay]
                inter = torch.clamp_min(iou._pieces(px, py, gx, gy)
                                        + iou._pieces(gx, gy, px, py),
                                        0.0) * 0.5
                s = sa[:, li]
                one = inter / torch.clamp_min(s + row[:, 8] - inter, iou.EPS)
                one = torch.where((s < iou.EPS) | (row[:, 8] < iou.EPS),
                                  torch.zeros_like(one), one)
                signed &= bool(((one >= 0) | torch.isnan(one)).all())
                best = torch.where((k < n8)[:, None],
                                   torch.maximum(best, one), best)
            key = best.view(torch.int32).long() & 0x7FFFFFFF
            bits[:, li] = torch.where(ran[:, None],
                                      torch.maximum(bits[:, li], key),
                                      bits[:, li])
    assert bool((seen == 1).all())  # the sub-tiles cover each pixel once
    out = bits.int().view(torch.float32)
    out = torch.where(torch.isfinite(out) & (out >= 0) & (out <= 1), out,
                      torch.zeros_like(out))
    return out, signed


@pytest.mark.parametrize("name", SCENES)
def test_prep_schedule_equals_the_plain_prep(name):
    deltas, pc, gt = _scene(name)
    cand, nv = emulate_prep(deltas, pc, gt)
    pcand, pnv, _, _ = iou.prepare_candidates(deltas, pc, gt, 32)
    assert torch.equal(nv, pnv)
    assert torch.equal(cand.view(torch.int32), pcand.view(torch.int32))
    if name == "crowded":  # the cap binds
        assert int(nv.max()) == 32
    if name == "padding":  # no live candidate in the empty frame
        assert int(nv[3:].max()) == 0
    if name == "overflow":  # a block of NaN keys, padding rows first
        assert int(nv[1]) == 0 and float(cand[1, :16].abs().sum()) == 0.0


@pytest.mark.parametrize("subs,chunk", [(8, 8), (1, 32), (4, 16)])
@pytest.mark.parametrize("name", SCENES)
def test_chunked_clip_equals_the_single_loop(name, subs, chunk):
    deltas, pc, gt = _scene(name)
    cand, nv, d, p = iou.prepare_candidates(deltas, pc, gt, 32)
    out, signed = emulate_clip(cand, nv, d, p, subs, chunk)
    want = iou.iou_target_plain_blocks(cand, nv, d, p)
    assert signed  # the combine is exact only for IoUs >= 0 or NaN
    assert torch.equal(out, want)
    assert float(want.max()) > 0.05


def test_overflow_scene_makes_nan_ious():
    # the NaN path is exercised, not only present: a pixel's running max
    # over its block's live candidates is NaN before the clean, which maps
    # it to 0
    deltas, pc, gt = _scene("overflow")
    cand, nv, d, p = iou.prepare_candidates(deltas, pc, gt, 32)
    ax, ay, sa = iou._decode_corners(d, p)
    n8 = ((nv.long() + 7) // 8 * 8).clamp(max=32)
    raw = torch.zeros_like(sa)
    for k in range(int(n8.max())):
        row = cand[:, k, :, None]
        gx = [row[:, 2 * i] for i in range(4)]
        gy = [row[:, 2 * i + 1] for i in range(4)]
        inter = torch.clamp_min(iou._pieces(ax, ay, gx, gy)
                                + iou._pieces(gx, gy, ax, ay), 0.0) * 0.5
        one = inter / torch.clamp_min(sa + row[:, 8] - inter, iou.EPS)
        raw = torch.where((k < n8)[:, None], torch.maximum(raw, one), raw)
    nan = torch.isnan(raw)
    assert bool(nan.any())
    assert float(iou.iou_target_plain_blocks(cand, nv, d, p)[nan]
                 .abs().max()) == 0.0


@pytest.mark.parametrize("name", SCENES)
def test_gt_stage_equals_gt_quantities(name):
    # the kernel's per-GT stage (a clockwise box reversed, the sums in
    # corner order) against the plain prep's per-GT quantities
    # (polygon_area's sign and |area|, the corners' mean, the circumradius):
    # bit for bit on the CPU, NaN and degenerate rows included
    _, _, gt = _scene(name)
    gt = gt.clone()
    gt[0, -1] = float("nan")
    gt[0, -2] = gt[0, -2, :1]  # four equal corners
    ccw = torch.where((boxes.polygon_area(gt) < 0)[..., None, None],
                      gt[..., [0, 3, 2, 1], :], gt)
    gc = ccw.mean(dim=-2)
    r_gt = torch.sqrt(((ccw - gc[:, :, None, :]) ** 2).sum(-1).amax(-1))
    want = torch.cat([ccw.reshape(*gt.shape[:2], 8),
                      boxes.polygon_area(ccw).abs()[..., None], gc,
                      r_gt[..., None]], dim=-1)
    got = _gt_stage(gt)
    same = got.view(torch.int32) == want.view(torch.int32)
    assert bool((same | (torch.isnan(got) & torch.isnan(want))).all())
    ok = ~torch.isnan(want).any(-1)
    assert bool((want[..., 8][ok] >= 0).all())


def test_bits_combine_equals_the_nan_propagating_max():
    # chunk maxima as the clip makes them (running maxima from +0 of IoUs
    # >= 0 or NaN: +-0, tiny, > 1, inf, NaN of either sign bit) met in any
    # order by a max of their bits without the sign bit, then cleaned:
    # the single loop's max over all chunks, then cleaned
    r = np.random.RandomState(3)
    pool = np.array([0.0, -0.0, 1e-30, 0.25, 0.5, 1.0, 1.0000001, np.inf,
                     np.nan, -np.nan], np.float32)
    v = torch.from_numpy(pool[r.randint(0, len(pool), (4096, 4))])
    key = v.view(torch.int32).long() & 0x7FFFFFFF
    got = key.amax(1).int().view(torch.float32)
    want = v[:, 0]
    for c in range(1, 4):
        want = torch.maximum(want, v[:, c])

    def clean(x):
        return torch.where(torch.isfinite(x) & (x >= 0) & (x <= 1), x,
                           torch.zeros_like(x))

    assert torch.equal(clean(got), clean(want))
    assert bool((torch.isnan(want) == torch.isnan(got)).all())


def test_local_index_is_a_bijection_with_rows_of_columns():
    j = torch.arange(TILE)
    li = iou.local_index(j)
    assert torch.equal(li.sort().values, j)
    # at H = 64 a warp's lanes take one row of 32 neighbouring columns
    n = li[:32 * 8].reshape(8, 32)
    assert bool(((n % 64) == torch.arange(8)[:, None]).all())
    assert torch.equal(n // 64, torch.arange(32).expand(8, 32))


@pytest.mark.parametrize("K,k,pc_stride", [(1, 0, 1), (3, 1, 1), (3, 2, 2)])
def test_strided_read_equals_the_planar_copy(K, k, pc_stride):
    # class k's slice of a (B, H, W, K*8) head tensor in the head's layout
    # (B, H, K*8, W) permuted, and pc as a stride-sliced view of a wider
    # frame, read through their strides in column-major block order: the
    # plain prep's planar copies, bit for bit
    deltas, pc, gt = _scene("sparse")
    B, H, W, _ = deltas.shape
    raw = torch.cat([deltas.permute(0, 1, 3, 2) * (1 + c)
                     for c in range(K)], dim=2)
    d = raw.permute(0, 1, 3, 2)[..., 8 * k:8 * (k + 1)]
    wide = torch.zeros(B, H, W * pc_stride, 3)
    wide[:, :, pc_stride // 2::pc_stride] = pc
    p = wide[:, :, pc_stride // 2::pc_stride]
    assert not d.is_contiguous() and (pc_stride == 1 or not p.is_contiguous())
    _, _, dp, pp = iou.prepare_candidates(d, p, gt, 32)
    nb = dp.shape[0] // B
    for b in range(B):
        for blk in range(nb):
            j, li, h, w = _pixels(H, W, blk, torch.arange(TILE))
            for C, t, planes in ((8, d, dp), (3, p, pp)):
                got = torch.stack([_read(t, b, h, w, c) for c in range(C)])
                want = planes[b * nb + blk][:, li]
                assert torch.equal(got.view(torch.int32),
                                   want.view(torch.int32)), (b, blk, C)
