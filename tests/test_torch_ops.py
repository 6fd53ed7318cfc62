"""The port's geometry and WNMS ops (rangedet_tpu_torch/ops) against the
JAX package's functions and the numpy oracles of the reference's C++/CUDA
ops, on the same numpy inputs, in f32."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracles
from conftest import random_csa
from rangedet_tpu.ops import boxes as jboxes
from rangedet_tpu.ops import decode as jdecode
from rangedet_tpu.ops import nms as jnms
from rangedet_tpu.ops import rotated_iou as jiou
from rangedet_tpu.ops import targets as jtargets
from rangedet_tpu_torch.ops import boxes, decode, nms, rotated_iou, targets

# one intra-op thread per test process: several workers share the cores
torch.set_num_threads(1)

T = torch.from_numpy


def _j(a):
    return np.array(a)


def test_decode_matches_jax_and_oracle(rng):
    n = 256
    deltas = rng.uniform(-1.5, 1.5, (n, 8)).astype(np.float32)
    pts = rng.uniform(-40, 40, (n, 3)).astype(np.float32)
    got = decode.decode_boxes(T(deltas), T(pts)).numpy()
    want_jax = _j(jdecode.decode_boxes(jnp.asarray(deltas), jnp.asarray(pts)))
    want = np.stack([oracles.decode_oracle(deltas[i], pts[i])
                     for i in range(n)])
    np.testing.assert_allclose(got, want_jax, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_iou_bev_matches_jax_and_oracle(rng):
    n = 64
    ca = _j(jboxes.csa_to_corners_bev(jnp.asarray(
        random_csa(rng, n, center_scale=4.0))))
    cb = _j(jboxes.csa_to_corners_bev(jnp.asarray(
        random_csa(rng, n, center_scale=4.0))))
    cb[:4] = ca[:4]  # exactly coincident quads take the area(A) branch
    cb[4] = cb[4, ::-1]  # clockwise order
    got = rotated_iou.iou_bev_corners(T(ca), T(cb)).numpy()
    want_jax = _j(jiou.iou_bev_corners(jnp.asarray(ca), jnp.asarray(cb)))
    want = np.array([oracles.iou_bev_oracle(ca[i], cb[i]) for i in range(4, n)])
    assert (want > 0.01).sum() > 10, "test setup should produce overlaps"
    np.testing.assert_allclose(got, want_jax, atol=1e-4)
    np.testing.assert_allclose(got[4:], want, atol=2e-4)
    np.testing.assert_allclose(got[:4], 1.0, atol=1e-5)
    # broadcast (N, 1) x (1, M), as the WNMS uses it
    mat = rotated_iou.iou_bev_corners(T(ca)[:, None], T(cb)[None]).numpy()
    np.testing.assert_allclose(
        mat, _j(jiou.iou_bev_matrix(jnp.asarray(ca), jnp.asarray(cb))),
        atol=1e-4,
    )


def test_box_formats_match_jax(rng):
    b10 = rng.uniform(-20, 20, (32, 10)).astype(np.float32)
    np.testing.assert_allclose(
        boxes.box10_to_box11(T(b10)).numpy(),
        _j(jboxes.box10_to_box11(jnp.asarray(b10))), atol=1e-5,
    )
    b12 = rng.uniform(-20, 20, (32, 12)).astype(np.float32)
    np.testing.assert_allclose(
        boxes.box12_to_box8_eval(T(b12)).numpy(),
        _j(jboxes.box12_to_box8_eval(jnp.asarray(b12))), atol=1e-4,
    )
    np.testing.assert_array_equal(
        boxes.box10_to_corners_bev(T(b10)).numpy(),
        _j(jboxes.box10_to_corners_bev(jnp.asarray(b10))),
    )


def test_interval_masks_and_stride_slice_match_jax(rng):
    rng_ = rng.uniform(0, 110, (16, 64, 1)).astype(np.float32)
    rng_[0, :6, 0] = [0, 15, 30, 100, 14.999, 29.999]  # interval edges
    iv = {1: (30, 100), 2: (15, 30), 4: (0, 15)}
    got = targets.interval_masks(T(rng_), iv, (1, 2, 4))
    want = jtargets.interval_masks(jnp.asarray(rng_), iv, (1, 2, 4))
    for s in (1, 2, 4):
        np.testing.assert_array_equal(got[s].numpy(), _j(want[s]))
        np.testing.assert_array_equal(
            targets.stride_slice(T(rng_), s, 1).numpy(),
            _j(jtargets.stride_slice(jnp.asarray(rng_), s, 1)),
        )


def _make_dets(rng, n, scale=8.0):
    csa = random_csa(rng, n, center_scale=scale)
    corners = _j(jboxes.csa_to_corners_bev(jnp.asarray(csa))).reshape(n, 8)
    bottom = (csa[:, 2] - csa[:, 5] / 2)[:, None]
    score = rng.uniform(0.05, 1.0, (n, 1)).astype(np.float32)
    return np.concatenate(
        [corners, csa[:, 6:7], bottom, csa[:, 5:6], score], axis=1
    ).astype(np.float32)


def _clustered(rng, n, n_clusters, scale):
    dets = _make_dets(rng, n, scale=scale)
    for k in range(0, 4 * n_clusters, 4):  # near-duplicates: voting, median
        dets[k + 1 : k + 4] = dets[k]
        dets[k + 1 : k + 4, :8] += rng.uniform(-0.2, 0.2, (3, 8))
        dets[k + 1 : k + 4, 11] = rng.uniform(0.05, 1.0, 3)
    return dets


def _both(dets, valid, **kw):
    got = nms.weighted_nms(T(dets[:, :11]), T(dets[:, 11]), T(valid), **kw)
    want = jnms.weighted_nms(
        jnp.asarray(dets[:, :11]), jnp.asarray(dets[:, 11]),
        jnp.asarray(valid), **kw,
    )
    return [g.numpy() for g in got], [_j(w) for w in want]


def test_wnms_matches_oracle_and_jax(rng):
    n = 60
    dets = _clustered(rng, n, 5, scale=6.0)
    want, _ = oracles.wnms_oracle(dets, thresh=0.1, thresh_vote=0.5)
    (out12, ov), (j12, jv) = _both(
        dets, np.ones(n, bool), thresh=0.1, thresh_vote=0.5, max_keep=n,
        block=16,
    )
    np.testing.assert_array_equal(ov, jv)
    np.testing.assert_allclose(out12, j12, rtol=1e-4, atol=1e-4)
    got = out12[ov]
    assert got.shape[0] == want.shape[0]
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


@functools.lru_cache(maxsize=None)
def _blocked_case(max_keep):
    """256 dets with partial validity and voting clusters, and the JAX
    blocked WNMS of them (computed once per max_keep)."""
    r = np.random.RandomState(0)
    dets = _clustered(r, 256, 16, scale=20.0)
    valid = r.uniform(size=256) > 0.2
    kw = dict(thresh=0.1, thresh_vote=0.5, max_keep=max_keep)
    ref = jnms.weighted_nms(jnp.asarray(dets[:, :11]),
                            jnp.asarray(dets[:, 11]), jnp.asarray(valid),
                            **kw, block=16)
    return dets, valid, kw, [_j(a) for a in ref]


@pytest.mark.parametrize("max_keep", [7, 64])  # 7 binds mid-block
@pytest.mark.parametrize("block", [1, 16, 19])
def test_wnms_blocked_matches_jax(max_keep, block):
    dets, valid, kw, (ref, v_ref) = _blocked_case(max_keep)
    out, v = [a.numpy() for a in nms.weighted_nms(
        T(dets[:, :11]), T(dets[:, 11]), T(valid), **kw, block=block)]
    np.testing.assert_array_equal(v, v_ref)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


def test_wnms_respects_validity_and_duplicates(rng):
    n = 16
    dets = _make_dets(rng, n)
    valid = np.zeros(n, bool)
    valid[:4] = True
    (out12, ov), (j12, jv) = _both(dets, valid, thresh=0.1, thresh_vote=0.5,
                                   max_keep=8)
    np.testing.assert_array_equal(ov, jv)
    np.testing.assert_allclose(out12, j12, rtol=1e-4, atol=1e-4)
    assert ov.sum() <= 4
    assert np.isin(np.round(out12[ov, 11], 5), np.round(dets[:4, 11], 5)).all()

    # identical boxes suppress into one row equal to the input box
    dup = np.repeat(_make_dets(rng, 1), 5, axis=0)
    dup[:, 11] = [0.9, 0.8, 0.7, 0.6, 0.5]
    (d12, dv), _ = _both(dup, np.ones(5, bool), thresh=0.1, thresh_vote=0.5,
                         max_keep=5)
    assert dv.sum() == 1
    np.testing.assert_allclose(d12[0, :11], dup[0, :11], rtol=1e-4)
    np.testing.assert_allclose(d12[0, 11], 0.9, rtol=1e-5)


def test_wnms_3d_mode_matches_jax(rng):
    n = 64
    dets = _clustered(rng, n, 8, scale=10.0)
    dets[1::2, 9] += 2.5  # half the boxes lifted: partial z overlap
    kw = dict(thresh=0.1, thresh_vote=0.5, max_keep=32, iou_3d=True)
    (out, v), (ref, v_ref) = _both(dets, np.ones(n, bool), **kw)
    np.testing.assert_array_equal(v, v_ref)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


def test_wnms_batched_frames_equal_single(rng):
    # frames run side by side; each equals its own single-frame run
    dets = [_clustered(rng, 96, 6, scale=12.0) for _ in range(3)]
    valid = [rng.uniform(size=96) > 0.3 for _ in range(3)]
    valid[2][:] = False  # a frame with nothing to do
    kw = dict(thresh=0.1, thresh_vote=0.5, max_keep=20)
    rows, rv = nms.weighted_nms(
        T(np.stack(dets)[..., :11]), T(np.stack(dets)[..., 11]),
        T(np.stack(valid)), **kw,
    )
    for f in range(3):
        r1, v1 = nms.weighted_nms(T(dets[f][:, :11]), T(dets[f][:, 11]),
                                  T(valid[f]), **kw)
        np.testing.assert_array_equal(rv[f].numpy(), v1.numpy())
        np.testing.assert_allclose(rows[f].numpy(), r1.numpy(), atol=1e-6)
    assert not rv[2].any()


# ------------------------------------------------ the loose functions
def _box10(rng, n, center_scale):
    csa = random_csa(rng, n, center_scale=center_scale)
    corners = _j(jboxes.csa_to_corners_bev(jnp.asarray(csa))).reshape(n, 8)
    z = np.stack([csa[:, 2] - csa[:, 5] / 2, csa[:, 2] + csa[:, 5] / 2], 1)
    return csa, np.concatenate([corners, z], 1).astype(np.float32)


def test_box10_to_csa7_and_canonicalize_ccw_match_jax(rng):
    csa, b10 = _box10(rng, 64, 20.0)
    got = boxes.box10_to_csa7(T(b10)).numpy()
    want = _j(jboxes.box10_to_csa7(jnp.asarray(b10)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(got[:, :6], csa[:, :6], rtol=1e-4, atol=1e-4)
    quads = b10[:, :8].reshape(-1, 4, 2).copy()
    quads[::2] = quads[::2, ::-1]  # every other one clockwise
    got = boxes.canonicalize_ccw(T(quads)).numpy()
    np.testing.assert_array_equal(
        got, _j(jboxes.canonicalize_ccw(jnp.asarray(quads))))
    assert (boxes.polygon_area(T(got)).numpy() > 0).all()


def test_iou_bev_matrix_and_iou_3d_csa_match_jax(rng):
    ca = random_csa(rng, 24, center_scale=4.0)
    cb = random_csa(rng, 16, center_scale=4.0)
    cb[:3] = ca[:3]  # identical boxes
    qa = _j(jboxes.csa_to_corners_bev(jnp.asarray(ca)))
    qb = _j(jboxes.csa_to_corners_bev(jnp.asarray(cb)))
    got = rotated_iou.iou_bev_matrix(T(qa), T(qb)).numpy()
    want = _j(jiou.iou_bev_matrix(jnp.asarray(qa), jnp.asarray(qb)))
    assert got.shape == (24, 16) and (want > 0.05).sum() > 20
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    got = rotated_iou.iou_3d_csa(T(ca[:, None]), T(cb[None])).numpy()
    want = _j(jiou.iou_3d_csa(jnp.asarray(ca[:, None]), jnp.asarray(cb[None])))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.diag(got[:3, :3]), 1.0, atol=1e-5)


@pytest.mark.parametrize("max_keep", [1, 10, 40])
def test_nms_3d_matches_jax(rng, max_keep):
    _, b10 = _box10(rng, 30, 5.0)
    scores = rng.uniform(0, 1, 30).astype(np.float32)
    scores[5] = scores[6]  # a tie keeps the input order
    valid = rng.uniform(size=30) > 0.15
    got = nms.nms_3d(T(b10), T(scores), T(valid), 0.2, max_keep)
    want = jnms.nms_3d(jnp.asarray(b10), jnp.asarray(scores),
                       jnp.asarray(valid), 0.2, max_keep)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), _j(w))
    k = int(got[2].sum())
    assert 0 < k <= max_keep and valid[got[1][:k].numpy()].all()
