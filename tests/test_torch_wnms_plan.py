"""The weighted-NMS kernel's schedule on the CPU.

csrc/wnms.cu runs only on the card. Here a torch emulation of its schedule
runs on the CPU: the score and yaw orders as sorts of its unique 64-bit
keys (NaN last, -0 as +0), its records (raw and CCW corners, |areas| by
the 4-term sums in corner order, circumcircles), per frame the rounds (the
block-th alive candidate bounds a round, its members taken CH at a time
from the alive mask), the circumcircle filter and the pair IoU written as
the kernel writes it, the chain on the members' kill bits, the voters of
each survivor, their median yaw picked by rank in the yaw order, and the
weighted sums in float64, a lane's voters in index order and the lanes by
the xor tree. Against the plain ``weighted_nms_plain`` it must give the
same validity, the same rounds a frame (the plain version's ``wnms.round``
ranges of the frame run alone) and the same score column bit for bit;
the 11 averaged values differ only by how the two versions add the same
f32 products (the plain one in f32 in torch's order), within
``mean_gap_bound``. The pair IoU is also held to
``rotated_iou.iou_bev_corners`` (and ``nms._det_iou`` in 3D) bit for bit
on each scene's pairs. On the card the kernel must equal this emulation
bit for bit.
"""
import re
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from rangedet_tpu_torch.ops import nms, rotated_iou

# one intra-op thread per test process: several workers share the cores
torch.set_num_threads(1)

CH = 16  # members a chunk
LANES = 32
EPS = 1e-8
TWO_PI = 2.0 * 3.1415926
VALUES = 11  # the values a row averages


def order_keys(x: np.ndarray) -> np.ndarray:
    """csrc/wnms.cu:order_key of each f32 element, with its index below,
    as uint64: sorting them is torch.sort(x, stable=True)."""
    a = np.asarray(x, np.float32).copy()
    a[a == 0] = 0.0
    b = a.view(np.uint32).astype(np.uint64)
    k = np.where(b & 0x80000000, ~b & 0xffffffff, b | 0x80000000)
    k = np.where(np.isnan(a), 0xffffffff, k).astype(np.uint64)
    return (k << np.uint64(32)) | np.arange(len(a), dtype=np.uint64)


def kernel_order(x: np.ndarray) -> np.ndarray:
    return np.argsort(order_keys(x), kind="stable")


def shoelace(q):
    """0.5 * (((c0 + c1) + c2) + c3) over q (..., 8)."""
    c = [q[..., 2 * i] * q[..., 2 * ((i + 1) % 4) + 1]
         - q[..., 2 * ((i + 1) % 4)] * q[..., 2 * i + 1] for i in range(4)]
    return 0.5 * (((c[0] + c[1]) + c[2]) + c[3])


def pieces(P, Q):
    """csrc/wnms.cu:pieces on (..., 8) corner tensors."""
    ex = [Q[..., 2 * ((j + 1) % 4)] - Q[..., 2 * j] for j in range(4)]
    ey = [Q[..., 2 * ((j + 1) % 4) + 1] - Q[..., 2 * j + 1] for j in range(4)]
    total = torch.zeros_like(P[..., 0])
    for i in range(4):
        i1 = (i + 1) % 4
        px, py = P[..., 2 * i], P[..., 2 * i + 1]
        qx, qy = P[..., 2 * i1], P[..., 2 * i1 + 1]
        for j in range(4):
            q0x, q0y = Q[..., 2 * j], Q[..., 2 * j + 1]
            f0 = ex[j] * (py - q0y) - ey[j] * (px - q0x)
            f1 = ex[j] * (qy - q0y) - ey[j] * (qx - q0x)
            denom = f0 - f1
            ts = f0 / torch.where(denom.abs() > EPS, denom, 1.0)
            a = torch.where((f0 < 0) & (f1 >= 0), ts, 0.0)
            b = torch.where((f0 >= 0) & (f1 < 0), ts, 1.0)
            out = (f0 < 0) & (f1 < 0)
            if j == 0:
                t0, t1, empty = a, b, out
            else:
                t0, t1 = torch.maximum(t0, a), torch.minimum(t1, b)
                empty = empty | out
        empty = empty | (t1 <= t0)
        dx, dy = qx - px, qy - py
        s0x, s0y = px + t0 * dx, py + t0 * dy
        s1x, s1y = px + t1 * dx, py + t1 * dy
        total = total + torch.where(empty, 0.0, s0x * s1y - s0y * s1x)
    return total


def records(d):
    """The kernel's records of dets d (K, 11) f32 in score order: a dict of
    (K, ...) f32 tensors."""
    raw = d[:, :8]
    area = shoelace(raw)
    ccw = torch.where((area < 0)[:, None], raw[:, [0, 1, 6, 7, 4, 5, 2, 3]],
                      raw)
    cx = (((ccw[:, 0] + ccw[:, 2]) + ccw[:, 4]) + ccw[:, 6]) * 0.25
    cy = (((ccw[:, 1] + ccw[:, 3]) + ccw[:, 5]) + ccw[:, 7]) * 0.25
    r2 = torch.zeros_like(cx)
    for c in range(4):
        dx, dy = ccw[:, 2 * c] - cx, ccw[:, 2 * c + 1] - cy
        r2 = torch.maximum(r2, dx * dx + dy * dy)
    return {"raw": raw, "ccw": ccw, "sa": area.abs(),
            "sccw": shoelace(ccw).abs(), "cx": cx, "cy": cy,
            "rad": torch.sqrt(r2), "yaw": d[:, 8], "bot": d[:, 9],
            "hgt": d[:, 10]}


def pair_iou(a, b, iou_3d):
    """csrc/wnms.cu:pair_iou of records a against records b (broadcast)."""
    m = (a["ccw"][..., 0] - b["ccw"][..., 0]).abs()
    for k in range(1, 8):
        m = torch.maximum(m, (a["ccw"][..., k] - b["ccw"][..., k]).abs())
    s = pieces(a["ccw"], b["ccw"]) + pieces(b["ccw"], a["ccw"])
    inter = torch.where(m < 1e-6, a["sccw"], torch.clamp(s, min=0.0) / 2.0)
    sa, sb = a["sa"], b["sa"]
    iou = inter / torch.clamp((sa + sb) - inter, min=EPS)
    bev = torch.where((sa < EPS) | (sb < EPS), 0.0, iou)
    if not iou_3d:
        return bev
    a0, h0, a1, h1 = a["bot"], a["hgt"], b["bot"], b["hgt"]
    z_ov = torch.clamp(torch.minimum(a0 + h0, a1 + h1)
                       - torch.maximum(a0, a1), min=0.0)
    inter3 = ((bev * (sa + sb)) / (1.0 + bev)) * z_ov
    return inter3 / torch.clamp((sa * h0 + sb * h1) - inter3, min=EPS)


def apart(a, b):
    """The circumcircle filter: member record a (scalars) vs records b."""
    dx, dy = a["cx"] - b["cx"], a["cy"] - b["cy"]
    rr = a["rad"] + b["rad"]
    reach = rr + 1e-3 * (rr + a["cx"].abs() + a["cy"].abs())
    return dx * dx + dy * dy > reach * reach


def lane_sum(js, terms):
    """The kernel's float64 sums of terms (n, C) over voters js (n,):
    lane (j // 32) % 32 adds its voters in index order, then the xor
    tree."""
    acc = torch.zeros((LANES, terms.shape[1]), dtype=torch.float64)
    for j, t in zip(js.tolist(), terms):
        lane = (j // 32) % LANES
        acc[lane] = acc[lane] + t
    idx = torch.arange(LANES)
    for o in (16, 8, 4, 2, 1):
        acc = acc + acc[idx ^ o]
    return acc[0]


def mean_gap_bound(m, a, w):
    """How far apart two f32 weighted means of the same m nonzero f32
    products may lie, each computed as fl(fl(sum p) / fl(sum w)), when the
    sums of one run in f32 in any order and those of the other in float64
    rounded once to f32: a = sum |p| (11,), w = sum of the weights. Each
    computed sum is within e * a of the exact one, e = (m + 1) * 2^-24
    (the f32 bound (m - 1) u / (1 - (m - 1) u) of any summation order, and
    u + (m - 1) * 2^-53 for the double one), the weight sum within e * w;
    so a quotient is within (2 e + u) a / (w (1 - e)^2) of the exact mean,
    and the two means twice that. A zero weight sum is clamped alike on
    both sides and gives equal rows."""
    u = 2.0 ** -24
    e = (m + 1) * u
    if float(w) == 0.0:
        return torch.zeros_like(a)
    return 2 * (2 * e + u) * a / (w * (1 - e) ** 2)


def emulate_frame(dets, scores, valid, thresh, thresh_vote, max_keep,
                  iou_3d, block, width=None):
    """One frame through the kernel's schedule -> (rows (width, 12),
    valid (width,), rounds, and the float64 bound (width, 11) of each
    row's gap to the plain version's f32 sums). A row of a launch of
    several classes: ``max_keep`` its cap, ``width`` the launch's rows a
    frame (default ``max_keep``)."""
    th, tv = torch.tensor(thresh, dtype=torch.float32), torch.tensor(
        thresh_vote, dtype=torch.float32)
    K = dets.shape[0]
    width = max_keep if width is None else width
    s_masked = torch.where(valid, scores, float("-inf"))
    order = torch.from_numpy(kernel_order((-s_masked).numpy()))
    d, sm, alive = dets[order], s_masked[order], valid[order].clone()
    rec = records(d)
    weight = torch.clamp(sm, min=0.0)
    ypos = torch.empty(K, dtype=torch.long)
    yorder = torch.from_numpy(kernel_order(rec["yaw"].numpy()))
    ypos[yorder] = torch.arange(K)
    yaw_by_pos = rec["yaw"][yorder]
    nf = (~torch.isfinite(dets)).sum(0)
    vals = d  # the 11 values a row averages, in their order
    filt = bool(th > 0) and bool(tv >= 0)
    rows = torch.zeros((width, 12))
    rv = torch.zeros(width, dtype=torch.bool)
    tol = torch.zeros((width, VALUES), dtype=torch.float64)
    r, cur, rounds = 0, 0, 0
    idx = torch.arange(K)

    def one(i):
        return {k: v[i] for k, v in rec.items()}

    while r < max_keep:
        ahead = torch.nonzero(alive & (idx >= cur))[:, 0]
        if len(ahead) == 0:
            break
        lim = int(ahead[min(block, len(ahead)) - 1])
        rounds += 1
        while True:
            cand = torch.nonzero(alive & (idx >= cur) & (idx <= lim))[:, 0]
            mem = cand[:CH].tolist()
            if not mem:
                break
            cur = mem[-1] + 1
            nm = len(mem)
            kill = torch.zeros((nm, K), dtype=torch.bool)
            vote = torch.zeros((nm, K), dtype=torch.bool)
            for b, mj in enumerate(mem):
                js = torch.nonzero(alive & (idx != mj))[:, 0]
                if filt:
                    js = js[~apart(one(mj), one(js))]
                iou = pair_iou(one(mj), one(js), iou_3d)
                kill[b, js] = iou >= th
                vote[b, js] = iou > tv
            S = []
            for b, mj in enumerate(mem):
                if not any(kill[c, mj] for c in S):
                    S.append(b)
            for rank, b in enumerate(S):
                if r + rank >= max_keep:
                    break
                mj = mem[b]
                dead = torch.zeros(K, dtype=torch.bool)
                for c in S:
                    if c < b:
                        dead |= kill[c]
                        dead[mem[c]] = True
                v = vote[b].clone()
                v[mj] = True
                js = torch.nonzero(v & alive & ~dead)[:, 0]
                yaw_i = rec["yaw"][mj]
                n, t = len(js), int((rec["yaw"][js] < yaw_i).sum())
                pos = torch.sort(ypos[js]).values
                med = yaw_i
                if n > 2:
                    k = n // 2
                    q = k if (n % 2 or k < t) else (k - 1 if k > t else -1)
                    if q >= 0:
                        med = yaw_by_pos[pos[q]] + 0.0
                ok = torch.fmod((rec["yaw"][js] - med).abs(), TWO_PI) < 0.3
                wt = torch.where(ok, weight[js], 0.0)
                keep = wt != 0
                js, wt = js[keep], wt[keep]
                prod = (wt[:, None] * vals[js]).double()  # f32 products
                terms = torch.cat([wt[:, None].double(), prod], 1)
                tot = lane_sum(js, terms)
                tol[r + rank] = mean_gap_bound(len(js), prod.abs().sum(0),
                                               wt.double().sum())
                nfv = (~torch.isfinite(vals[js])).sum(0)
                ws = torch.clamp(tot[0].float(), min=1e-12)
                s = torch.where(nf > nfv, float("nan"), tot[1:].float())
                rows[r + rank, :VALUES] = s / ws
                rows[r + rank, VALUES] = sm[mj]
                rv[r + rank] = True
            for c in S:
                alive &= ~kill[c]
                alive[mem[c]] = False
            r = min(max_keep, r + len(S))
            if r >= max_keep:
                break
        cur = lim + 1
    return rows, rv, rounds, tol


def plain_frame(dets, scores, valid, kw):
    """The plain version on one frame alone, and its wnms.round ranges."""
    rounds = []
    real = nms.span

    def count(name):
        if name == "wnms.round":
            rounds.append(1)
        return real(name)

    with mock.patch.object(nms, "span", count):
        rows, rv = nms.weighted_nms_plain(dets, scores, valid, **kw)
    return rows, rv, len(rounds)


def _boxes(r, n, centers, size, yaw, jitter, flip=0.0):
    """n dets (n, 11) f32 and their scores: candidates around ``centers``
    (m, 2) with lengths/widths ``size`` (m, 2) and headings ``yaw`` (m,),
    each moved by ``jitter``; a share ``flip`` of them clockwise."""
    m = len(centers)
    who = r.randint(0, m, n)
    ctr = centers[who] + r.normal(0, jitter, (n, 2))
    lw = size[who] * (1 + r.normal(0, jitter / 10, (n, 2)))
    h = yaw[who] + r.normal(0, jitter / 6, n)
    lx = np.stack([0.5, -0.5, -0.5, 0.5]) * lw[:, :1]
    wy = np.stack([-0.5, -0.5, 0.5, 0.5]) * lw[:, 1:]
    c, s = np.cos(h)[:, None], np.sin(h)[:, None]
    x = ctr[:, :1] + lx * c - wy * s
    y = ctr[:, 1:] + lx * s + wy * c
    corners = np.stack([x, y], -1)
    cw = r.uniform(size=n) < flip
    corners[cw] = corners[cw][:, ::-1]
    bottom = r.normal(-1.0, 0.1, (n, 1))
    height = r.uniform(1.4, 1.8, (n, 1))
    dets = np.concatenate([corners.reshape(n, 8), h[:, None], bottom,
                           height], 1)
    return dets.astype(np.float32), r.uniform(0.5, 1.0, n).astype(np.float32)


def _scene_objects(r, m, scale):
    return (r.uniform(-scale, scale, (m, 2)),
            np.stack([r.uniform(3.5, 5.0, m), r.uniform(1.6, 2.2, m)], 1),
            r.uniform(-np.pi, np.pi, m))


KW = dict(thresh=0.1, thresh_vote=0.5, max_keep=200, iou_3d=False,
          block=16)


def _case(name):
    """-> (dets (F, K, 11) or (K, 11), scores, valid, kw)."""
    r = np.random.RandomState(sum(map(ord, name)))
    kw = dict(KW)
    if name == "cap":  # F = 4 frames at the 4096-candidate cap
        frames = [_boxes(r, 4096, *_scene_objects(r, 300, 50.0), 0.35,
                         flip=0.1) for _ in range(4)]
        dets = np.stack([f[0] for f in frames])
        scores = np.stack([f[1] for f in frames])
        valid = np.ones(scores.shape, bool)
    elif name == "crowded":  # exact duplicates, tied scores and yaws
        dets, scores = _boxes(r, 320, *_scene_objects(r, 10, 12.0), 0.2)
        dets[1::2] = dets[0::2]
        dets[2::4, :8] += 0.05
        scores = np.round(scores * 4) / 4
        dets[::3, 8] = dets[0, 8]
        dets, scores = dets[None], scores[None]
        valid = np.ones(scores.shape, bool)
        kw["max_keep"] = 64
    elif name == "empty":  # the second frame has no valid candidate
        dets, scores = zip(*[_boxes(r, 200, *_scene_objects(r, 8, 15.0), 0.3)
                             for _ in range(2)])
        dets, scores = np.stack(dets), np.stack(scores)
        valid = np.ones(scores.shape, bool)
        valid[1] = False
        valid[0, r.uniform(size=200) < 0.3] = False
    elif name == "small":  # K < block
        dets, scores = _boxes(r, 5, *_scene_objects(r, 2, 3.0), 0.3)
        dets, scores = dets[None], scores[None]
        valid = np.ones(scores.shape, bool)
    elif name == "midblock":  # max_keep binds inside a round of 2 chunks
        dets, scores = _boxes(r, 300, *_scene_objects(r, 30, 20.0), 0.3)
        dets, scores = dets[None], scores[None]
        valid = np.ones(scores.shape, bool)
        kw.update(max_keep=23, block=19)
    elif name == "iou_3d":
        dets, scores = _boxes(r, 400, *_scene_objects(r, 12, 15.0), 0.3)
        dets[1::2, 9] += 1.0  # half lifted: partial z overlap
        dets, scores = dets[None], scores[None]
        valid = np.ones(scores.shape, bool)
        kw.update(iou_3d=True, max_keep=64)
    elif name == "single":  # one (K, 11) frame
        dets, scores = _boxes(r, 500, *_scene_objects(r, 20, 20.0), 0.3,
                              flip=0.5)
        valid = r.uniform(size=500) > 0.1
    elif name == "unfiltered":  # thresh 0: every pair computed
        dets, scores = _boxes(r, 100, *_scene_objects(r, 6, 10.0), 0.3)
        dets, scores = dets[None], scores[None]
        valid = np.ones(scores.shape, bool)
        kw["thresh"] = 0.0
    elif name == "nonfinite":  # inf in an invalid row: the sums' NaN
        dets, scores = _boxes(r, 150, *_scene_objects(r, 6, 10.0), 0.3)
        dets[7, 9] = np.inf
        dets[8, 2] = np.nan
        valid = np.ones(150, bool)
        valid[[7, 8]] = False
        dets, scores, valid = dets[None], scores[None], valid[None]
    return (torch.from_numpy(dets), torch.from_numpy(scores),
            torch.from_numpy(valid), kw)


def _same(a, b):
    """Bit for bit, but a NaN equals any NaN (its sign is the machine's:
    x86 makes 0 * inf a negative NaN, the card a positive one)."""
    nan = torch.isnan(a)
    return (torch.equal(nan, torch.isnan(b)) and torch.equal(
        a[~nan].view(torch.int32), b[~nan].view(torch.int32)))


def _within(a, b, tol):
    """Rows a against b: the score column bit for bit, the 11 averaged
    values within tol (equal where tol is 0), a NaN as any NaN."""
    if not _same(a[:, VALUES], b[:, VALUES]):
        return False
    x, y = a[:, :VALUES].double(), b[:, :VALUES].double()
    nan = torch.isnan(x)
    if not torch.equal(nan, torch.isnan(y)):
        return False
    ok = (x == y) | ((x - y).abs() <= tol)
    return bool(ok[~nan].all())


CASES = ["cap", "crowded", "empty", "small", "midblock", "iou_3d", "single",
         "unfiltered", "nonfinite"]


@pytest.mark.parametrize("name", CASES)
def test_kernel_schedule_equals_plain(name):
    dets, scores, valid, kw = _case(name)
    frames = [(dets, scores, valid)] if dets.dim() == 2 else list(
        zip(dets, scores, valid))
    for f, (d, s, v) in enumerate(frames):
        rows, rv, rounds, tol = emulate_frame(d, s, v, **kw)
        want, wv, want_rounds = plain_frame(d, s, v, kw)
        assert torch.equal(rv, wv), (name, f)
        assert _within(rows, want, tol), (name, f)
        assert rounds == want_rounds, (name, f, rounds, want_rounds)
        if name == "cap":
            assert rounds >= 10 and int(rv.sum()) == kw["max_keep"], rounds
    if name == "single":  # the public function's single-frame form
        out, ov = nms.weighted_nms(dets, scores, valid, **kw)
        assert torch.equal(ov, wv) and _same(out, want)

    # the pair IoU as the kernel writes it, against the plain one
    d = frames[0][0]
    rec = records(d)
    n = min(64, d.shape[0])
    a = {k: v[:n, None] for k, v in rec.items()}
    b = {k: v[None] for k, v in rec.items()}
    got = pair_iou(a, b, kw["iou_3d"])
    if kw["iou_3d"]:
        want = nms._det_iou(d[None], d[None, :n], True)[0]
    else:
        c = d[:, :8].reshape(-1, 4, 2)
        want = rotated_iou.iou_bev_corners(c[:n, None], c[None])
    assert _same(got, want), name
    # the filter drops only pairs whose IoU is 0
    far = apart(a, b)
    assert (want[far] == 0).all(), name


def _class_rows():
    """Rows of a launch of three classes: frames of the "cap" case as
    each frame's three classes (row f = 3 b + k), a keep cap and a
    candidate count a class -> (dets (F, K, 11), scores, valid, caps,
    counts); a row's columns past its count are padding, zero and
    invalid, as ``models/detector.py:run_inference`` pads a class."""
    dets, scores, valid, _ = _case("cap")
    caps, counts = [200, 200, 100], [4096, 1024, 2560]
    dets = dets[:2, None].expand(-1, 3, -1, -1).reshape(6, 4096, 11).clone()
    scores = scores[:2, None].expand(-1, 3, -1).reshape(6, 4096).clone()
    valid = valid[:2, None].expand(-1, 3, -1).reshape(6, 4096).clone()
    scores[1::3] *= 0.9  # the classes' scores differ
    for f in range(6):
        dets[f, counts[f % 3]:] = 0.0
        valid[f, counts[f % 3]:] = False
    return dets, scores, valid, caps, counts


def test_kernel_schedule_with_row_caps_equals_plain():
    """A launch's rows of other keep caps and candidate counts through the
    kernel's schedule, each row in its padded place: validity, rounds and
    score column equal the plain version's on the row's own candidates
    and cap, bit for bit, the averaged values within ``mean_gap_bound``;
    the rows past a row's cap zero and invalid; and the plain version over
    all rows at once is held to its rows alone alike."""
    dets, scores, valid, caps, counts = _class_rows()
    kw = dict(KW, max_keep=caps)
    rows, rv = nms.weighted_nms_plain(dets, scores, valid, **kw)
    assert tuple(rows.shape) == (6, 200, 12)
    for f in range(6):
        cap, n = caps[f % 3], counts[f % 3]
        one = dict(KW, max_keep=cap)
        e_rows, e_valid, e_rounds, tol = emulate_frame(
            dets[f], scores[f], valid[f], width=200, **one)
        want, wv, want_rounds = plain_frame(dets[f, :n], scores[f, :n],
                                            valid[f, :n], one)
        assert torch.equal(e_valid[:cap], wv), f
        assert e_rounds == want_rounds, (f, e_rounds, want_rounds)
        assert _within(e_rows[:cap], want, tol[:cap]), f
        assert not e_valid[cap:].any() and not e_rows[cap:].any(), f
        assert torch.equal(rv[f, :cap], wv), f
        assert _within(rows[f, :cap], want, tol[:cap]), f
        assert not rv[f, cap:].any() and not rows[f, cap:].any(), f
        assert int(wv.sum()) == cap, f  # the caps bind


def test_kernel_constants_match_the_wrapper():
    """ops/nms.py's MAX_K, SCRATCH and MAX_CLASSES are csrc/wnms.cu's: the
    wrapper refuses what the kernel refuses and sizes the scratch it
    indexes."""
    src = (Path(nms.__file__).parents[1] / "csrc" / "wnms.cu").read_text()

    def const(name):
        return re.search(rf"constexpr int {name} = ([^;]+);", src).group(1)

    assert int(const("MAX_K")) == nms.MAX_K
    assert int(const("MAX_CLASSES")) == nms.MAX_CLASSES
    assert const("SCRATCH") == "REC + 2"
    assert int(const("REC")) + 2 == nms.SCRATCH


def _eval_b4_calls(dev):
    """The weighted-NMS calls of the benchmark's ``veh.eval.b4`` content
    (its 8 batches and weights from ``content_seed``), as the eval step
    makes them on the card: [(args, kwargs)]."""
    from portbench.run import content_seed, load_spec, port_config, to_device
    from portbench.traffic.frames import make_pool
    from portbench.weights import model_weights
    from rangedet_tpu_torch.infer import build_eval_inputs
    from rangedet_tpu_torch.models import RangeDet
    from rangedet_tpu_torch.models.detector import run_inference

    _, _, config, traffic = load_spec("veh.eval.b4")
    c, seed = config["config"], content_seed(0, traffic)
    cfg = port_config(config, False)
    model = RangeDet(**cfg.model_kwargs()).to(dev)
    model.load_state_dict(model_weights(c, seed, dev), strict=True)
    model.eval()
    calls = []

    def grab(*a, **kw):
        calls.append((a, kw))
        return nms.weighted_nms_plain(*a, **kw)

    with torch.inference_mode(), mock.patch.object(nms, "weighted_nms",
                                                   grab):
        for batch in make_pool(seed, traffic, c):
            inputs = build_eval_inputs(to_device(batch, dev), cfg, dev)
            run_inference(*model(inputs["input_data"], inputs["coord"]),
                          inputs, cfg)
    return calls


@pytest.mark.cuda
def test_kernel_matches_plain_on_cuda():
    """On the card, the kernel on the scenes above and on ``veh.eval.b4``'s
    8 batches: its rows, validity and rounds a frame equal this module's
    emulation of its schedule bit for bit (a NaN as any NaN); against the
    plain version run there, validity, the rounds a frame and the score
    column are equal, and the averaged values lie within
    ``mean_gap_bound`` (the kill, vote and yaw decisions agree; only the
    order and precision of the sums differ); one launch a call, and the
    wrapper's refusals."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    calls = []
    for name in CASES:
        d, s, v, kw = _case(name)
        calls.append(((d.to(dev), s.to(dev), v.to(dev)), kw, name))
    calls += [(a, kw, f"eval_b4[{i}]")
              for i, (a, kw) in enumerate(_eval_b4_calls(dev))]
    assert len(calls) == len(CASES) + 8
    for (d, s, v), kw, name in calls:
        kw = {k: kw[k] for k in KW if k in kw}
        n0 = nms.LAUNCHES
        rows, rv = nms.weighted_nms(d, s, v, **kw)
        assert nms.LAUNCHES == n0 + 1, name
        if d.dim() == 2:
            d, s, v = d[None], s[None], v[None]
            rows, rv = rows[None], rv[None]
        k_rows, k_valid, rounds = nms.wnms_kernel(d, s, v, **kw)
        assert torch.equal(k_valid, rv) and _same(k_rows, rows), name
        rounds = rounds.tolist()
        for f, (df, sf, vf) in enumerate(zip(d, s, v)):
            e_rows, e_valid, e_rounds, tol = emulate_frame(
                df.cpu(), sf.cpu(), vf.cpu(), **kw)
            got = rows[f].cpu()
            assert torch.equal(rv[f].cpu(), e_valid), (name, f)
            assert rounds[f] == e_rounds, (name, f, rounds, e_rounds)
            assert _same(got, e_rows), (
                name, f, float((got - e_rows).abs().nan_to_num().max()))
            want, wv, want_rounds = plain_frame(df, sf, vf, kw)
            assert torch.equal(rv[f], wv), (name, f)
            assert rounds[f] == want_rounds, (name, f, rounds, want_rounds)
            assert _within(got, want.cpu(), tol), (
                name, f, float((got - want.cpu()).abs().nan_to_num().max()))

    # one launch of rows of three classes, their caps and counts mixed:
    # each row equals the emulation of its padded place and the kernel on
    # the row's own candidates and cap, bit for bit (the kernel sums and
    # ranks voters only, so the padding is not read)
    d, s, v, caps, counts = _class_rows()
    n0 = nms.LAUNCHES
    k_rows, k_valid, rounds = nms.wnms_kernel(
        d.to(dev), s.to(dev), v.to(dev), KW["thresh"], KW["thresh_vote"],
        caps, KW["iou_3d"], KW["block"])
    assert nms.LAUNCHES == n0 + 1
    assert tuple(k_rows.shape) == (6, 200, 12)
    rounds = rounds.tolist()
    for f in range(6):
        cap, n = caps[f % 3], counts[f % 3]
        one = dict(KW, max_keep=cap)
        e_rows, e_valid, e_rounds, _ = emulate_frame(
            d[f], s[f], v[f], width=200, **one)
        assert torch.equal(k_valid[f].cpu(), e_valid), f
        assert rounds[f] == e_rounds, (f, rounds, e_rounds)
        assert _same(k_rows[f].cpu(), e_rows), f
        a_rows, a_valid, a_rounds = nms.wnms_kernel(
            d[f:f + 1, :n].contiguous().to(dev),
            s[f:f + 1, :n].contiguous().to(dev),
            v[f:f + 1, :n].contiguous().to(dev), KW["thresh"],
            KW["thresh_vote"], cap, KW["iou_3d"], KW["block"])
        assert torch.equal(k_valid[f, :cap], a_valid[0]), f
        assert _same(k_rows[f, :cap].cpu(), a_rows[0].cpu()), f
        assert int(a_rounds[0]) == rounds[f], f

    d, s, v, kw = _case("small")
    d, s, v = d.to(dev), s.to(dev), v.to(dev)
    with pytest.raises(ValueError):  # a negative keep cap
        nms.wnms_kernel(d, s, v, 0.1, 0.5, [8, -1])
    with pytest.raises(ValueError):  # more classes than the kernel takes
        nms.wnms_kernel(d, s, v, 0.1, 0.5, [8] * (nms.MAX_CLASSES + 1))
    with pytest.raises(TypeError):
        nms.wnms_kernel(d.double(), s, v, 0.1, 0.5, 8)
    with pytest.raises(TypeError):
        nms.wnms_kernel(d, s, v.float(), 0.1, 0.5, 8)
    with pytest.raises(ValueError):  # not contiguous
        nms.wnms_kernel(torch.cat([d, d], -1)[..., :11], s, v, 0.1, 0.5, 8)
    big = nms.MAX_K + 1
    with pytest.raises(ValueError):
        nms.weighted_nms(torch.zeros((1, big, 11), device=dev),
                         torch.zeros((1, big), device=dev),
                         torch.ones((1, big), dtype=torch.bool, device=dev),
                         0.1, 0.5, 8)
