"""The train slice's modules of rangedet_tpu_torch against the JAX package,
on the CPU at small sizes: the data copy, assignment and dense targets, the
IoU target (plain version vs the Pallas kernel in interpret mode), the
losses, and the conv3x3 autograd Function's plain backward vs jax.vjp of
the Pallas custom VJPs. Inputs come from numpy seeds and feed both sides.

On the CPU every wrapper takes its plain version; chip_smoke.py and the
cuda-marked test hold the kernels to the plain versions on the card."""
import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rangedet_tpu.data import synthetic as jax_synthetic
from rangedet_tpu.models import losses as JL
from rangedet_tpu.models.detector import build_train_targets as jax_targets
from rangedet_tpu.models.layers import deconv_bhcw_phase_conv
from rangedet_tpu.ops import assigner as jax_assigner
from rangedet_tpu.ops import boxes as jax_boxes
from rangedet_tpu.ops import conv_pallas
from rangedet_tpu.ops import rotated_iou as jax_iou
from rangedet_tpu.ops import targets as jax_targets_ops
from rangedet_tpu.ops.iou_target_pallas import iou_target_fused
from rangedet_tpu_torch.data import synthetic
from rangedet_tpu_torch.models import losses as L
from rangedet_tpu_torch.models.detector import build_train_targets
from rangedet_tpu_torch.models.layers import deconv_bhcw
from rangedet_tpu_torch.ops import assigner, boxes, decode, rotated_iou
from rangedet_tpu_torch.ops import conv3x3 as conv
from rangedet_tpu_torch.ops import iou_target as iou
from rangedet_tpu_torch.ops import targets
from torch_parity import port_config
from tiny import tiny_config

# one intra-op thread per test process: several workers share the cores
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
# the same f32 math in another order (or another libm's transcendental,
# a few ulp): per element |a - b| <= 1e-5 + 1e-5 |b|
ULP_TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


# ---------------------------------------------------------------- data
@pytest.mark.parametrize("seed,style", [(0, "paint"), (3, "paint"),
                                        (5, "vehicles")])
def test_synthetic_copy_makes_the_same_batches(seed, style):
    cfg = tiny_config(feat_size=(16, 120), pad_field=(16, 128))
    want = jax_synthetic.make_batch(cfg, 2, seed=seed, num_boxes=5,
                                    style=style)
    got = synthetic.make_batch(cfg, 2, seed=seed, num_boxes=5, style=style)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("epoch,i", [(0, 0), (0, 1), (2, 7)])
def test_train_cli_draws_the_jax_cli_synthetic_batches(epoch, i):
    """tools.train's batch of step i of an epoch is tools/train.py's
    synthetic draw: a fresh style="vehicles" batch, seed epoch*10000+i."""
    from rangedet_tpu_torch.tools.train import synthetic_batch

    jcfg = tiny_config(feat_size=(16, 120), pad_field=(16, 128))
    want = jax_synthetic.make_batch(jcfg, jcfg.batch_image,
                                    seed=epoch * 10000 + i, style="vehicles")
    got = synthetic_batch(port_config(jcfg), epoch, i)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------------------------------------------------------- targets
def _batch_with_nlz(seed=0):
    cfg = tiny_config()
    batch = synthetic.make_batch(cfg, 2, seed=seed, num_boxes=6)
    # a no-label zone over a quarter of the columns of frame 0
    batch["is_in_nlz"][0, :, :32] = 1.0
    return cfg, batch


def test_assignment_is_exact_with_no_label_zones():
    _, batch = _batch_with_nlz()
    for b in range(2):
        pc = batch["pc"][b].reshape(-1, 3)
        args = (batch["mask"][b].reshape(-1), batch["gt_valid"][b],
                batch["is_in_nlz"][b].reshape(-1))
        want = jax_assigner.assign_points_to_boxes(
            jnp.asarray(pc),
            jax_boxes.csa_to_corners3d(jnp.asarray(batch["gt_csa"][b])),
            *map(jnp.asarray, args))
        got = assigner.assign_points_to_boxes(
            _t(pc), boxes.csa_to_corners3d(_t(batch["gt_csa"][b])),
            *map(_t, args))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert (got >= 0).sum() > 20  # the scene assigns points
    # the zone excludes points that were assigned without it
    pc0 = _t(batch["pc"][0].reshape(-1, 3))
    corners = boxes.csa_to_corners3d(_t(batch["gt_csa"][0]))
    mask0 = _t(batch["mask"][0].reshape(-1))
    free = assigner.assign_points_to_boxes(pc0, corners, mask0,
                                           _t(batch["gt_valid"][0]))
    zoned = assigner.assign_points_to_boxes(
        pc0, corners, mask0, _t(batch["gt_valid"][0]),
        _t(batch["is_in_nlz"][0].reshape(-1)))
    assert (zoned <= free).all() and (zoned < free).any()


def test_box_corners_and_counts_match_jax(rng):
    csa = rng.randn(5, 7).astype(np.float32) * 3
    csa[:, 3:6] = np.abs(csa[:, 3:6]) + 0.5
    np.testing.assert_allclose(
        boxes.csa_to_corners3d(_t(csa)).numpy(),
        np.asarray(jax_boxes.csa_to_corners3d(jnp.asarray(csa))), **ULP_TOL)
    a = rng.randint(-1, 5, size=300).astype(np.int32)
    np.testing.assert_array_equal(
        assigner.normalization_weight(_t(a), 5).numpy(),
        np.asarray(jax_assigner.normalization_weight(jnp.asarray(a), 5)))


def test_dense_targets_match_jax_with_two_classes():
    cfg, batch = _batch_with_nlz(seed=1)
    b = 1
    pc = batch["pc"][b]
    gt_class = batch["gt_class"][b].copy()
    gt_class[1::2] = 2.0  # a second class in label_set (1, 2)
    assign = jax_assigner.assign_points_to_boxes(
        jnp.asarray(pc.reshape(-1, 3)),
        jax_boxes.csa_to_corners3d(jnp.asarray(batch["gt_csa"][b])),
        jnp.asarray(batch["mask"][b].reshape(-1)),
        box_valid=jnp.asarray(batch["gt_valid"][b]))
    kw = dict(label_set=(1, 2), reg_dim_weights=tuple(cfg.reg_dim_weights))
    want = jax_targets_ops.generate_dense_targets(
        jnp.asarray(pc), jnp.asarray(batch["gt_csa"][b]),
        jnp.asarray(gt_class), assign, **kw)
    got = targets.generate_dense_targets(
        _t(pc), _t(batch["gt_csa"][b]), _t(gt_class),
        _t(np.asarray(assign)), **kw)
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **ULP_TOL)
    # weights and one-hots are exact, not just close
    for k in ("reg_normalize_weight", "rpn_reg_weight", "rpn_cls_target"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    # the per-point pieces, on the same assignment
    np.testing.assert_allclose(
        targets.reg_targets(_t(pc.reshape(-1, 3)), _t(batch["gt_csa"][b]),
                            _t(np.asarray(assign))).numpy(),
        np.asarray(jax_targets_ops.reg_targets(
            jnp.asarray(pc.reshape(-1, 3)), jnp.asarray(batch["gt_csa"][b]),
            assign)), **ULP_TOL)
    np.testing.assert_array_equal(
        targets.cls_targets(_t(gt_class), _t(np.asarray(assign)),
                            (1, 2)).numpy(),
        np.asarray(jax_targets_ops.cls_targets(jnp.asarray(gt_class), assign,
                                               (1, 2))))


def test_build_train_targets_matches_jax():
    cfg, batch = _batch_with_nlz(seed=2)
    want = jax_targets({k: jnp.asarray(v) for k, v in batch.items()}, cfg)
    got = build_train_targets({k: _t(v) for k, v in batch.items()},
                              port_config(cfg))
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **ULP_TOL)


# ---------------------------------------------------------------- IoU
def _scene(B, H, W, M, seed, crowd=False):
    """pc on an azimuth grid, mild deltas, GT boxes scattered near pixels;
    with ``crowd`` all M boxes cluster around one pixel."""
    r = np.random.RandomState(seed)
    az = np.linspace(-np.pi, np.pi, W, endpoint=False)
    rad = r.uniform(3.0, 60.0, size=(B, H, W))
    pc = np.stack([rad * np.cos(az)[None, None], rad * np.sin(az)[None, None],
                   r.uniform(-1, 1, size=(B, H, W))], -1).astype(np.float32)
    deltas = (r.randn(B, H, W, 8) * 0.3).astype(np.float32)
    if crowd:
        ctr = pc[0, 4, 37, :2][None, None] + r.uniform(-2, 2, (B, M, 2))
        lw = r.uniform(2.5, 6.0, size=(B, M, 2))
    else:
        idx = r.randint(0, H * W, size=(B, M))
        ctr = pc.reshape(B, -1, 3)[np.arange(B)[:, None], idx][..., :2]
        lw = r.uniform(1.5, 5.0, size=(B, M, 2))
    yaw = r.uniform(-np.pi, np.pi, size=(B, M))
    c, s = np.cos(yaw), np.sin(yaw)
    lx = np.stack([1, -1, -1, 1], -1) * lw[..., :1] / 2
    wy = np.stack([1, 1, -1, -1], -1) * lw[..., 1:] / 2
    gt = np.stack([ctr[..., :1] + lx * c[..., None] - wy * s[..., None],
                   ctr[..., 1:2] + lx * s[..., None] + wy * c[..., None]],
                  -1).astype(np.float32)
    return deltas, pc, gt


@pytest.mark.parametrize("crowd", [False, True])
def test_plain_iou_target_equals_the_pallas_kernel(crowd):
    # sparse: 24 GTs on a 16 x 256 image (2 blocks); crowded: 48
    # GTs around one pixel, so a block has more than G = 32 live candidates
    # and the JAX kernel's one-sided cap binds
    M = 48 if crowd else 24
    deltas, pc, gt = _scene(1, 16, 256, M, seed=11 + crowd, crowd=crowd)
    want = np.asarray(iou_target_fused(jnp.asarray(deltas), jnp.asarray(pc),
                                       jnp.asarray(gt), 32, True))
    got = iou.iou_target(_t(deltas), _t(pc), _t(gt), topk_gt=32).numpy()
    assert got.shape == (1, 16, 256)
    # XLA on the CPU contracts multiply-adds into FMAs and has its own exp,
    # each one ulp off torch's in ~10% of the elements; the Green's-theorem
    # sum of cross products of coordinates up to 60 m cancels down to the
    # intersection area, so one ulp of a coordinate moves a tiny IoU by up
    # to ~1e-5 (measured 7.9e-6 at IoU 1.8e-5). Every overlap and every
    # candidate choice agrees; values agree to 2e-5 + 1e-4 relative.
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-5)
    assert ((got > 1e-3) == (want > 1e-3)).all()
    assert want.max() > 0.05
    _, nv, _, _ = iou.prepare_candidates(_t(deltas), _t(pc), _t(gt), 32)
    assert (int(nv.max()) == 32) == crowd  # the cap binds only when crowded
    if crowd:  # and binds for real: a larger G finds more overlap
        full = iou.iou_target(_t(deltas), _t(pc), _t(gt), topk_gt=M).numpy()
        assert (full >= got).all() and (full > got + 1e-3).any()


@pytest.mark.parametrize("topk_gt", [0, 8])
def test_plain_iou_target_equals_dense_max_iou_when_uncapped(topk_gt):
    # the independent reference of the IoU target, the JAX step's
    # use_pallas_iou=False path: decode (with trig) -> BEV corners -> max
    # IoU over the GTs (all, or the topk_gt nearest by center). Rotated IoU,
    # port vs JAX, agrees to 1e-4 (tests/test_torch_ops.py). On the sparse
    # scene no block has more than G = 32 live candidates, where the
    # kernel's contract is exact, so the blocked trig-free target equals the
    # dense one to the same 1e-4 (the trig decode moves corners by ulps).
    deltas, pc, gt = _scene(1, 16, 256, 24, seed=11)
    corners = boxes.box10_to_corners_bev(decode.decode_boxes(
        _t(deltas).reshape(-1, 8), _t(pc).reshape(-1, 3)))
    dense = rotated_iou.max_iou_vs_gt(corners, _t(gt[0]), topk_gt)
    want = jax_iou.max_iou_vs_gt(jnp.asarray(corners.numpy()),
                                 jnp.asarray(gt[0]), topk_gt)
    np.testing.assert_allclose(dense.numpy(), np.asarray(want), atol=1e-4)
    assert float(dense.max()) > 0.05
    if topk_gt == 0:
        got = iou.iou_target(_t(deltas), _t(pc), _t(gt), topk_gt=32)
        np.testing.assert_allclose(got.reshape(-1).numpy(), dense.numpy(),
                                   atol=1e-4)


def test_iou_target_zero_gt_and_no_history():
    deltas, pc, gt = _scene(1, 8, 128, 4, seed=3)
    d = _t(deltas).requires_grad_(True)
    out = iou.iou_target(d, _t(pc), torch.zeros(1, 4, 4, 2))
    assert float(out.abs().max()) == 0.0 and not out.requires_grad


# ---------------------------------------------------------------- losses
def test_losses_match_jax(rng):
    logits = rng.randn(2, 8, 32, 1).astype(np.float32) * 2
    iou_t = np.clip(rng.rand(2, 8, 32, 1) - 0.5, 0, 1).astype(np.float32)
    mask = (rng.rand(2, 8, 32, 1) > 0.3).astype(np.float32)
    delta, tgt = (rng.randn(2, 2, 8, 32, 8).astype(np.float32) * 0.5)
    w = (rng.rand(2, 8, 32, 8) > 0.5).astype(np.float32) * 3
    nw = rng.rand(2, 8, 32, 8).astype(np.float32) * 0.1
    pairs = [
        (L.vfl_cls_loss(*map(_t, (logits, iou_t, mask)), 0.75, 2.0),
         JL.vfl_cls_loss(*map(jnp.asarray, (logits, iou_t, mask)), 0.75,
                         2.0)),
        (L.sigmoid_bce_with_logits(_t(logits), _t(iou_t)),
         JL.sigmoid_bce_with_logits(jnp.asarray(logits), jnp.asarray(iou_t))),
    ]
    for l1 in (False, True):
        pairs.append((
            L.normalized_reg_loss(*map(_t, (delta, tgt, w, nw)), 3.0, l1),
            JL.normalized_reg_loss(*map(jnp.asarray, (delta, tgt, w, nw)),
                                   3.0, l1)))
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-7)
    # the targets are detached: gradients reach the predictions only
    lt, tt = _t(logits).requires_grad_(True), _t(iou_t).requires_grad_(True)
    L.vfl_cls_loss(lt, tt, _t(mask)).backward()
    assert lt.grad is not None and tt.grad is None
    gl = jax.grad(lambda x: JL.vfl_cls_loss(x, jnp.asarray(iou_t),
                                            jnp.asarray(mask)))(
        jnp.asarray(logits))
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(gl), rtol=1e-5,
                               atol=1e-8)


# ---------------------------------------------------------------- conv VJP
def _conv_inputs(rng, B, H, Ci, W, Co):
    x = rng.randn(B, H, Ci, W).astype(np.float32)
    w = (0.1 * rng.randn(3, 3, Ci, Co)).astype(np.float32)
    s = (1.0 + 0.3 * rng.randn(Ci)).astype(np.float32)
    b = (0.2 * rng.randn(Ci)).astype(np.float32)
    return x, w, s, b


def _assert_grads_close(got, want):
    for g, wnt in zip(got, want):
        wnt = np.asarray(wnt)
        np.testing.assert_allclose(g.numpy(), wnt, rtol=1e-4,
                                   atol=1e-4 * np.abs(wnt).max())


def _port_vjp(x, w, s, b, stride, stats, cts):
    leaves = [_t(a).requires_grad_(True) for a in (x, w, s, b)
              if a is not None]
    xt, wt = leaves[:2]
    st, bt = leaves[2:] if s is not None else (None, None)
    out = conv.conv3x3(xt, wt, st, bt, stride, stats)
    outs = out if stats else (out,)
    sum(((o * _t(c)).sum() for o, c in zip(outs, cts))).backward()
    return outs, [t.grad for t in leaves]


@pytest.mark.parametrize("ingest,stats", [(False, False), (True, False),
                                          (False, True), (True, True)])
def test_conv_backward_matches_pallas_vjp(rng, ingest, stats):
    x, w, s, b = _conv_inputs(rng, 2, 8, 16, 40, 24)
    gy = rng.randn(2, 8, 24, 40).astype(np.float32)
    gs1 = rng.randn(24).astype(np.float32)  # nonzero stats cotangents
    gs2 = (0.1 * rng.randn(24)).astype(np.float32)
    fn = {(False, False): conv_pallas.conv3x3_bhcw,
          (True, False): conv_pallas.conv3x3_bnrelu_bhcw,
          (False, True): conv_pallas.conv3x3_stats_bhcw,
          (True, True): conv_pallas.conv3x3_bnrelu_stats_bhcw}[ingest, stats]
    prim = (x, w, s, b) if ingest else (x, w)
    want_out, vjp = jax.vjp(lambda *a: fn(*a, None, True),
                            *map(jnp.asarray, prim))
    cts = (gy, gs1, gs2) if stats else (gy,)
    want = vjp(tuple(map(jnp.asarray, cts)) if stats else jnp.asarray(gy))
    outs, got = _port_vjp(x, w, s if ingest else None, b if ingest else None,
                          1, stats, cts)
    wo = want_out if stats else (want_out,)
    for o, wv in zip(outs, wo):
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(wv),
                                   rtol=1e-4, atol=1e-4 * np.abs(wv).max())
    _assert_grads_close(got, want)


def test_stride2_backward_matches_pallas_phase_vjp(rng):
    # the JAX TPU path of a stride-2 conv of a PendingBN with stats: the
    # phase-packed fused conv (layers.py:conv3x3_bhcw_consume)
    x, w, s, b = _conv_inputs(rng, 2, 8, 8, 64, 16)
    cts = (rng.randn(2, 8, 16, 32).astype(np.float32),
           rng.randn(16).astype(np.float32),
           (0.1 * rng.randn(16)).astype(np.float32))

    def jax_fn(x, w, s, b):
        Ci = x.shape[2]
        x2 = jnp.concatenate([x[..., 0::2], x[..., 1::2]], axis=2)
        kp = jnp.zeros((3, 3, 2 * Ci, w.shape[-1]), w.dtype)
        kp = kp.at[:, 1, :Ci].set(w[:, 0]).at[:, 1, Ci:].set(w[:, 1])
        kp = kp.at[:, 2, :Ci].set(w[:, 2])
        return conv_pallas.conv3x3_bnrelu_stats_bhcw(
            x2, kp, jnp.concatenate([s, s]), jnp.concatenate([b, b]), None,
            True)

    _, vjp = jax.vjp(jax_fn, *map(jnp.asarray, (x, w, s, b)))
    want = vjp(tuple(map(jnp.asarray, cts)))
    _, got = _port_vjp(x, w, s, b, 2, True, cts)
    _assert_grads_close(got, want)


@pytest.mark.parametrize("kw,s,W", [(8, 4, 32), (4, 2, 64)])
def test_deconv_backward_matches_pallas_vjp(rng, kw, s, W):
    x = rng.randn(2, 8, 8, W).astype(np.float32)
    k = (0.1 * rng.randn(3, kw, 8, 8)).astype(np.float32)
    ct = rng.randn(2, 8, 8, W * s).astype(np.float32)
    _, vjp = jax.vjp(lambda x, k: deconv_bhcw_phase_conv(x, k, s, True),
                     jnp.asarray(x), jnp.asarray(k))
    dx_want, dk_want = vjp(jnp.asarray(ct))
    xt = _t(x).requires_grad_(True)
    # the port's weight is nn.ConvTranspose2d's (Ci, Co, kh, kw), flipped
    wt = _t(k).permute(2, 3, 0, 1).flip(2, 3).contiguous().requires_grad_(True)
    (deconv_bhcw(xt, wt, s) * _t(ct)).sum().backward()
    dk = wt.grad.flip(2, 3).permute(2, 3, 0, 1)
    _assert_grads_close([xt.grad, dk], [dx_want, dk_want])


def test_first_conv_skips_the_data_gradient(rng):
    x, w, _, _ = _conv_inputs(rng, 1, 4, 8, 16, 8)
    wt = _t(w).requires_grad_(True)
    calls = []
    real = conv.conv3x3_dgrad
    conv.conv3x3_dgrad = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        conv.conv3x3(_t(x), wt).sum().backward()
    finally:
        conv.conv3x3_dgrad = real
    assert wt.grad is not None and not calls


# ---------------------------------------------------------------- imports
def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_nothing_of_jax_or_the_jax_package():
    files = sorted((REPO / "rangedet_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    covered = {f.parent.name for f in files}
    assert {"configs", "eval", "data", "ops", "tools", "train",
            "utils", "parallel"} <= covered, covered
    assert REPO / "rangedet_tpu_torch" / "data" / "augment.py" in files
    for new in ("data/device_cache.py", "data/synthetic_device.py",
                "tools/quality_probe.py", "tools/overfit_probe.py",
                "tools/flops.py", "tools/train.py", "parallel/dist.py",
                "parallel/dp_step.py", "data/waymo_builder.py",
                "data/kitti.py", "tools/create_range_image_roidb.py",
                "tools/create_range_image_in_kitti.py"):
        assert REPO / "rangedet_tpu_torch" / new in files, new
    banned = {"jax", "flax", "optax", "rangedet_tpu"}
    bad = [(str(f.relative_to(REPO)), m) for f in files for m in _imports(f)
           if m.split(".")[0] in banned]
    assert not bad, bad


# ---------------------------------------------------------------- card
@pytest.mark.cuda
def test_train_kernels_match_plain_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    r = np.random.RandomState(0)
    dev = torch.device("cuda")
    x, w, s, b = (_t(a).to(dev) for a in _conv_inputs(r, 2, 8, 24, 96, 40))
    xb, wb = x.bfloat16(), w.bfloat16()
    gy = torch.randn(2, 8, 40, 96, device=dev).bfloat16()
    cot = (torch.randn(2, 8, 40, 96, device=dev).bfloat16(),
           torch.randn(40, device=dev), torch.randn(40, device=dev))
    y, s1, s2 = conv.conv3x3_bhcw(xb, wb, s, b, 1, True)
    yp = conv.conv3x3_bhcw_plain(xb, wb, s, b, 1, out_dtype=torch.float32)
    assert ((y.float() - yp).abs() <= 2 ** -6 * yp.abs()
            + 1e-3 * yp.abs().max()).all()
    torch.testing.assert_close(s1, y.float().sum((0, 1, 3)), rtol=1e-4,
                               atol=1e-3)
    dx, ds, db = conv.conv3x3_dgrad(gy, wb, cot, (xb, s, b))
    rdx, rds, rdb = conv.conv3x3_dgrad_plain(gy, wb, cot, (xb, s, b),
                                             out_dtype=torch.float32)
    assert ((dx.float() - rdx).abs() <= 2 ** -6 * rdx.abs()
            + 1e-3 * rdx.abs().max()).all()
    for a, ref in ((ds, rds), (db, rdb)):
        assert (a - ref).abs().max() <= 1e-3 * ref.abs().max()
    # the dgrad where its geometry is ragged: W = 166 and 70, Cdx = 8 and
    # 72, Cgy = 72 and 136 (two K-blocks, ragged), each cot / affine pair
    for (B, H, Cg, Cx, W, with_cot, aff) in [
            (2, 6, 128, 128, 166, True, True), (1, 5, 72, 8, 70, True, False),
            (1, 4, 136, 72, 200, False, True), (1, 3, 64, 136, 130, False,
                                                False)]:
        gd = torch.randn(B, H, Cg, W, device=dev).bfloat16()
        wd = (torch.randn(3, 3, Cx, Cg, device=dev) / (3 * Cx ** 0.5)
              ).bfloat16()
        cd = (torch.randn(B, H, Cg, W, device=dev).bfloat16(),
              0.1 * torch.randn(Cg, device=dev),
              0.05 * torch.randn(Cg, device=dev)) if with_cot else None
        ad = (torch.randn(B, H, Cx, W, device=dev).bfloat16(),
              1 + 0.3 * torch.randn(Cx, device=dev),
              0.2 * torch.randn(Cx, device=dev)) if aff else None
        out = conv.conv3x3_dgrad(gd, wd, cd, ad)
        ref = conv.conv3x3_dgrad_plain(gd, wd, cd, ad,
                                       out_dtype=torch.float32)
        o0, r0 = (out[0], ref[0]) if aff else (out, ref)
        assert ((o0.float() - r0).abs() <= 2 ** -6 * r0.abs()
                + 1e-3 * r0.abs().max()).all(), (B, Cg, Cx, W)
        if aff:
            for a, r in zip(out[1:], ref[1:]):
                assert (a - r).abs().max() <= 1e-3 * r.abs().max()
        again = conv.conv3x3_dgrad(gd, wd, cd, ad)
        assert torch.equal(o0, again[0] if aff else again)
    dw = conv.conv3x3_wgrad(xb, gy, s, b, cot)
    rdw = conv.conv3x3_wgrad_plain(xb, gy, s, b, cot)
    assert (dw - rdw).abs().max() <= 1e-3 * rdw.abs().max()
    # the wgrad kernel where its geometry is ragged: W % 8 != 0 (rows that
    # TMA cannot read in place), Ci = 8 and 72 (part of a 64-channel box),
    # Co = 512 (eight co tiles), with and without the ingest and the cot
    for (B, H, Ci, W, Co, ingest, with_cot) in [
            (2, 6, 128, 166, 128, True, True), (2, 5, 8, 130, 64, False, True),
            (1, 4, 72, 200, 128, False, True), (1, 3, 128, 166, 512, False,
                                                False)]:
        xw = torch.randn(B, H, Ci, W, device=dev).bfloat16()
        gw = torch.randn(B, H, Co, W, device=dev).bfloat16()
        sw = (1 + 0.3 * torch.randn(Ci, device=dev),
              0.2 * torch.randn(Ci, device=dev)) if ingest else (None, None)
        cw = (torch.randn(B, H, Co, W, device=dev).bfloat16(),
              0.1 * torch.randn(Co, device=dev),
              0.05 * torch.randn(Co, device=dev)) if with_cot else None
        dw = conv.conv3x3_wgrad(xw, gw, *sw, cw)
        rdw = conv.conv3x3_wgrad_plain(xw, gw, *sw, cw)
        assert (dw - rdw).abs().max() <= 1e-3 * rdw.abs().max(), (B, Ci, W)
        assert torch.equal(dw, conv.conv3x3_wgrad(xw, gw, *sw, cw))
    deltas, pc, gt = _scene(2, 16, 256, 24, seed=11)
    got = iou.iou_target(_t(deltas).to(dev), _t(pc).to(dev), _t(gt).to(dev))
    want = iou.iou_target_plain(_t(deltas).to(dev), _t(pc).to(dev),
                                _t(gt).to(dev))
    assert (got - want).abs().max() <= 1e-5
    # class k's slice of a K = 3 head tensor in the head's layout (the
    # width innermost, channels at stride W), read by stride in place
    raw = torch.cat([_t(deltas).permute(0, 1, 3, 2) * s
                     for s in (0.5, 1.0, 1.5)], dim=2).to(dev)
    head = raw.permute(0, 1, 3, 2)  # (B, H, W, 24)
    for k in range(3):
        d = head[..., 8 * k:8 * (k + 1)]
        got = iou.iou_target(d, _t(pc).to(dev), _t(gt).to(dev))
        want = iou.iou_target_plain(d, _t(pc).to(dev), _t(gt).to(dev))
        assert (got - want).abs().max() <= 1e-5, k
        # the prep kernel's nv and candidate order are the plain prep's;
        # a row's area may differ by an ulp (the shoelace terms added in
        # another order than torch's reduction)
        cand, nv, _ = iou.candidates(d, _t(pc).to(dev), _t(gt).to(dev))
        pcand, pnv, _, _ = iou.prepare_candidates(d, _t(pc).to(dev),
                                                  _t(gt).to(dev), 32)
        assert torch.equal(nv, pnv), k
        assert torch.equal(cand[..., :8], pcand[..., :8]), k
        torch.testing.assert_close(cand[..., 8], pcand[..., 8], rtol=1e-6,
                                   atol=0)
