"""The multiclass recipe (rangedet_multiclass_all_36e, K = 3 classes) of the
port against the JAX package, on the CPU at the tiny config: the synthetic
scenes of three classes, the class-aware dense targets and the per-class GT
corners, the head's K logits and 8K deltas through the weight bridge, the
losses over K classes, the IoU target on each class's view of the head's
deltas, one train step (materialized and fused Meta-Kernel block), the
per-class eval step, and the chain train -> test -> evaluate_pred -> export
from files of three classes, trained with the recipe's augmentation."""
import contextlib
import io
import json
import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_train as TT
from rangedet_tpu.data import synthetic as jax_synthetic
from rangedet_tpu.models import losses as JL
from rangedet_tpu.models.detector import build_train_targets as jax_targets
from rangedet_tpu.ops import assigner as jax_assigner
from rangedet_tpu.ops import boxes as jax_boxes
from rangedet_tpu.ops import targets as jax_targets_ops
from rangedet_tpu.ops.iou_target_pallas import iou_target_fused
from rangedet_tpu_torch.convert import from_flax, to_flax
from rangedet_tpu_torch.data import synthetic
from rangedet_tpu_torch.data.synthetic import CLASS_FAMILIES, write_waymo_files
from rangedet_tpu_torch.models import losses as L
from rangedet_tpu_torch.models.detector import build_train_targets
from rangedet_tpu_torch.ops import iou_target as iou
from rangedet_tpu_torch.ops import targets
from rangedet_tpu_torch.tools import create_prediction_bin_3d as bin_cli
from rangedet_tpu_torch.tools import evaluate_pred
from rangedet_tpu_torch.tools import test as test_cli
from rangedet_tpu_torch.tools import train as train_cli
from tiny import tiny_config
from torch_parity import TINY_PORT_CONFIG, check_eval_step, port_config

# one intra-op thread per test process: several workers share the cores
torch.set_num_threads(1)

RECIPE = "rangedet_multiclass_all_36e"
LABELS = (1, 2, 4)
H, W = 16, 128  # the tiny config's feat_size and pad_field


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _cfg(**kw):
    return tiny_config(RECIPE, layout="bhcw", dtype=jnp.float32, **kw)


def _dims_ok(csa, cls):
    """Each box's (l, w, h) inside its class's family ranges."""
    for c in LABELS:
        dims = csa[cls == c][:, 3:6]
        for j, (lo, hi) in enumerate(CLASS_FAMILIES[c][0]):
            assert (dims[:, j] >= lo).all() and (dims[:, j] <= hi).all(), c


# ---------------------------------------------------------------- data
@pytest.mark.parametrize("seed,style", [(0, "paint"), (4, "vehicles")])
def test_multiclass_batches_match_jax(seed, style):
    cfg = _cfg()
    assert tuple(cfg.label_set) == LABELS
    want = jax_synthetic.make_batch(cfg, 2, seed=seed, num_boxes=12,
                                    style=style)
    got = synthetic.make_batch(cfg, 2, seed=seed, num_boxes=12, style=style)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    valid = got["gt_valid"] > 0
    assert sorted(set(got["gt_class"][valid].tolist())) == list(LABELS)
    if style == "vehicles":
        _dims_ok(got["gt_csa"][valid], got["gt_class"][valid])


def test_written_files_carry_three_classes_with_their_dims(tmp_path):
    recs = write_waymo_files(str(tmp_path), 3, H=H, W=W, seed=2,
                             num_boxes=10, class_choices=LABELS)
    cls = np.concatenate([r["gt_class"] for r in recs])
    csa = np.concatenate([r["gt_bbox_csa"] for r in recs])
    assert sorted(set(cls.tolist())) == list(LABELS)
    _dims_ok(csa, cls)


# ---------------------------------------------------------------- targets
def _assert_targets_match(got, want):
    """Every target exact but the regression targets, whose atan2, cos and
    sin are torch's and XLA's: those within tests/test_torch_train_ops.py's
    ULP_TOL, as for one class (a few elements differ by an ulp)."""
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        if k.startswith(("reg_target", "rpn_reg_target")):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       err_msg=k, rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                          err_msg=k)


@pytest.fixture(scope="module")
def batch():
    b = synthetic.make_batch(_cfg(), 2, seed=3, num_boxes=10,
                             style="vehicles")
    b["is_in_nlz"][0, :, :16] = 1.0  # a no-label zone in frame 0
    return b


def test_class_targets_and_expansion_are_exact(batch):
    for f in range(2):
        pc = batch["pc"][f]
        assign = jax_assigner.assign_points_to_boxes(
            jnp.asarray(pc.reshape(-1, 3)),
            jax_boxes.csa_to_corners3d(jnp.asarray(batch["gt_csa"][f])),
            jnp.asarray(batch["mask"][f].reshape(-1)),
            box_valid=jnp.asarray(batch["gt_valid"][f]))
        assert (np.asarray(assign) >= 0).sum() > 20
        cls_t = targets.cls_targets(_t(batch["gt_class"][f]),
                                    _t(np.asarray(assign)), LABELS)
        np.testing.assert_array_equal(cls_t.numpy(), np.asarray(
            jax_targets_ops.cls_targets(jnp.asarray(batch["gt_class"][f]),
                                        assign, LABELS)))
        assert set(cls_t.unique().tolist()) == {0, 1, 2, 3}  # 3 = background
        data = np.random.RandomState(f).randn(pc.size // 3, 8).astype(
            np.float32)
        np.testing.assert_array_equal(
            targets.class_aware_expand(_t(data), cls_t, 3).numpy(),
            np.asarray(jax_targets_ops.class_aware_expand(
                jnp.asarray(data), jnp.asarray(cls_t.numpy()), 3)))
        kw = dict(label_set=LABELS, reg_dim_weights=(3, 1, 1, 1, 1, 1, 1, 1))
        want = jax_targets_ops.generate_dense_targets(
            jnp.asarray(pc), jnp.asarray(batch["gt_csa"][f]),
            jnp.asarray(batch["gt_class"][f]), assign, **kw)
        got = targets.generate_dense_targets(
            _t(pc), _t(batch["gt_csa"][f]), _t(batch["gt_class"][f]),
            _t(np.asarray(assign)), **kw)
        _assert_targets_match(got, want)
        assert got["rpn_reg_target"].shape[-1] == 24


def test_build_train_targets_is_exact(batch):
    cfg = _cfg()
    want = jax_targets({k: jnp.asarray(v) for k, v in batch.items()}, cfg)
    got = build_train_targets({k: _t(v) for k, v in batch.items()},
                              port_config(cfg))
    assert {f"gt_corners_cls{k}" for k in range(3)} <= set(got)
    _assert_targets_match(got, want)
    for k, label in enumerate(LABELS):  # each class's rows, the rest zero
        rows = np.abs(got[f"gt_corners_cls{k}"].numpy()).sum((2, 3)) > 0
        want_rows = (batch["gt_class"] == label) & (batch["gt_valid"] > 0)
        np.testing.assert_array_equal(rows, want_rows)


# ---------------------------------------------------------------- model
def test_head_carries_k_logits_and_8k_deltas_through_the_bridge():
    # the forward itself at K = 3 is held to JAX's by the train and eval
    # step tests below
    from rangedet_tpu_torch.models import RangeDet

    pcfg = port_config(_cfg(is_train=False))
    model = RangeDet(**pcfg.model_kwargs())
    model.init_from(torch.Generator().manual_seed(0))
    sd = model.state_dict()
    for lvl in range(3):  # a distinct prior for each class
        sd[f"head.cls_logit_lvl_{lvl}_bias"] = torch.tensor([-2.0, -1.0, 0.5])
    params, stats = to_flax(sd)
    for lvl in range(3):
        assert params["head"][f"cls_logit_lvl_{lvl}_bias"].shape == (3,)
        assert params["head"][f"reg_delta_lvl_{lvl}_bias"].shape == (24,)
    back = from_flax(params, stats)
    assert sorted(back) == sorted(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
    model.load_state_dict(back)
    b = synthetic.make_batch(pcfg, 1, seed=0, num_boxes=4)
    with torch.inference_mode():
        logits, deltas = model.eval()(_t(b["input_data"]), _t(b["coord"]))
    for lvl, s in enumerate(pcfg.fpn_strides):
        assert logits[lvl].shape == (1, H, W // s, 3)
        assert deltas[lvl].shape == (1, H, W // s, 24)


def test_losses_over_three_classes_match_jax(rng):
    logits = rng.randn(2, 8, 32, 3).astype(np.float32) * 2
    iou_t = np.clip(rng.rand(2, 8, 32, 3) - 0.5, 0, 1).astype(np.float32)
    mask = (rng.rand(2, 8, 32, 1) > 0.3).astype(np.float32)
    delta, tgt = rng.randn(2, 2, 8, 32, 24).astype(np.float32) * 0.5
    w = (rng.rand(2, 8, 32, 24) > 0.5).astype(np.float32) * 3
    nw = rng.rand(2, 8, 32, 24).astype(np.float32) * 0.1
    pairs = [(L.vfl_cls_loss(*map(_t, (logits, iou_t, mask))),
              JL.vfl_cls_loss(*map(jnp.asarray, (logits, iou_t, mask))))]
    for l1 in (False, True):
        pairs.append((
            L.normalized_reg_loss(*map(_t, (delta, tgt, w, nw)), 3.0, l1),
            JL.normalized_reg_loss(*map(jnp.asarray, (delta, tgt, w, nw)),
                                   3.0, l1)))
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-7)


def test_iou_target_on_each_class_view_matches_the_pallas_kernel():
    # the head's (B, H, W, 24) deltas, class k's 8 channels a view at
    # offset 8k with a pixel stride of 24, GTs of three classes
    r = np.random.RandomState(21)
    B, Hs, Ws, M = 1, 16, 128, 24
    az = np.linspace(-np.pi, np.pi, Ws, endpoint=False)
    rad = r.uniform(3.0, 60.0, size=(B, Hs, Ws))
    pc = np.stack([rad * np.cos(az)[None, None], rad * np.sin(az)[None, None],
                   r.uniform(-1, 1, size=(B, Hs, Ws))], -1).astype(np.float32)
    deltas = (r.randn(B, Hs, Ws, 24) * 0.3).astype(np.float32)
    gt_csa = np.zeros((B, M, 7), np.float32)
    idx = r.randint(0, Hs * Ws, size=(B, M))
    gt_csa[..., :3] = pc.reshape(B, -1, 3)[np.arange(B)[:, None], idx]
    gt_csa[..., 3:6] = r.uniform(1.0, 5.0, size=(B, M, 3))
    gt_csa[..., 6] = r.uniform(-np.pi, np.pi, size=(B, M))
    cls = np.tile(np.array(LABELS, np.float32), M // 3)[None]
    gt_bev = jax_boxes.csa_to_corners_bev(jnp.asarray(gt_csa))
    gts = [np.asarray(jnp.where((cls == label)[..., None, None], gt_bev,
                                0.0)) for label in LABELS]
    # JAX's kernel once, on the three classes' slices stacked as frames
    want = np.asarray(iou_target_fused(
        jnp.concatenate([jnp.asarray(deltas)[..., 8 * k:8 * k + 8]
                         for k in range(3)]),
        jnp.asarray(np.concatenate([pc] * 3)),
        jnp.asarray(np.concatenate(gts)), 32, True))
    td = _t(deltas)
    for k in range(3):
        view = td[..., 8 * k:8 * k + 8]
        assert view.storage_offset() == 8 * k and view.stride()[2] == 24
        got = iou.iou_target(view, _t(pc), _t(gts[k]), topk_gt=32).numpy()
        # tests/test_torch_train_ops.py's bound (FMAs and exp of XLA)
        np.testing.assert_allclose(got, want[k:k + 1], rtol=1e-4, atol=2e-5)
        assert ((got > 1e-3) == (want[k:k + 1] > 1e-3)).all()
        assert want[k].max() > 0.05
        assert np.array_equal(got, iou.iou_target(
            view.contiguous(), _t(pc), _t(gts[k]), topk_gt=32).numpy())


# ---------------------------------------------------------------- train step
@pytest.fixture(scope="module")
def one_step():
    # tests/test_torch_train.py's step set-up at K = 3
    return TT._one_step(_cfg(use_pallas_meta=False, use_pallas_iou=False,
                             iou_topk_gt=0).replace(base_lr=0.01,
                                                    warmup_epochs=0))


@pytest.fixture(scope="module")
def fused_step():
    # tests/test_torch_train.py's fused-block set-up at K = 3
    import jax

    cfg = _cfg(use_pallas_meta=True, use_pallas_iou=False, iou_topk_gt=0,
               feat_size=(5, 64), pad_field=(5, 64), fpn_strides=(1,),
               fpn_intervals={1: (0.0, 200.0)}, cls_conv_layers=0,
               reg_conv_layers=0).replace(base_lr=0.01, warmup_epochs=0)
    flag = "jax_disable_most_optimizations"
    before = jax.config.read(flag)
    jax.config.update(flag, True)
    try:
        return TT._one_step(cfg, port_init=True)
    finally:
        jax.config.update(flag, before)


@pytest.mark.parametrize("step", ["one_step", "fused_step"])
def test_train_step_metrics_match_jax(step, request):
    TT._assert_metrics_match(request.getfixturevalue(step))


@pytest.mark.parametrize("step", ["one_step", "fused_step"])
def test_train_step_updates_match_jax(step, request):
    TT._assert_updates_match(request.getfixturevalue(step))


# ---------------------------------------------------------------- eval step
def test_eval_step_per_class_matches_jax():
    check_eval_step("bhcw", use_pallas_meta=False, recipe=RECIPE)


# ---------------------------------------------------------------- files
def test_train_test_evaluate_export_from_files(tmp_path):
    """tools.train with the tiny multiclass recipe (augmenting) for one step
    -> checkpoint 0 -> tools.test -> three AP lines -> Waymo types 1, 2, 4
    in the export."""
    data, exp = str(tmp_path / "data"), str(tmp_path / "exp")
    for split, n, seed in (("training", 2, 6), ("validation", 2, 7)):
        write_waymo_files(data, n, H=H, W=W, seed=seed, image_set=split,
                          num_boxes=8, class_choices=LABELS)
    recipe = tmp_path / "tiny_multiclass.py"
    recipe.write_text(TINY_PORT_CONFIG.replace(
        '"rangedet_veh_wo_aug_4_18e"', f'"{RECIPE}"').replace(
        'device_topk={"veh": 256}',
        'device_topk={"veh": 256, "ped": 256, "cyc": 256}'))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        hist, _, val = train_cli.main([
            "--config", str(recipe), "--data-root", data, "--sampling-rate",
            "1", "--batch", "2", "--epochs", "1", "--steps-per-epoch", "1",
            "--num-workers", "1", "--eval-every", "1", "--eval-frames", "2",
            "--experiment-dir", exp, "--device", "cpu"])
        pred = test_cli.main([
            "--config", str(recipe), "--data-root", data, "--image-set",
            "validation", "--batch", "2", "--experiment-dir", exp,
            "--epoch", "0", "--device", "cpu",
            "--output", str(tmp_path / "pred.pkl")])
        records = evaluate_pred.main(["--config", str(recipe), "--pred",
                                      pred])
        n = bin_cli.main(["--pred", pred, "--out",
                          str(tmp_path / "pred.json")])
    assert len(hist) == 1 and np.isfinite(hist[0]["total_loss"])
    assert sorted(val[0]) == ["cyc", "ped", "veh"]
    assert "checkpoint epoch 0" in out.getvalue()
    with open(pred, "rb") as f:
        anno, outputs = pickle.load(f), pickle.load(f)
    assert len(outputs) == 2 and sorted(anno) == sorted(outputs)
    n_det = {}
    for rec in outputs.values():
        assert sorted(rec["det_xyzlwhyaws"]) == ["cyc", "ped", "veh"]
        for c, d in rec["det_xyzlwhyaws"].items():
            assert d.shape[1:] == (8,) and np.isfinite(d).all()
            n_det[c] = n_det.get(c, 0) + len(d)
    assert [(r["class"], r["iou"], r["frames"]) for r in records] == [
        ("veh", 0.7, 2), ("ped", 0.5, 2), ("cyc", 0.5, 2)]
    with open(tmp_path / "pred.json") as f:
        rows = json.load(f)
    assert n == len(rows) == sum(n_det.values())
    by_type = {t: sum(r["type"] == t for r in rows) for t in LABELS}
    assert by_type == {1: n_det["veh"], 2: n_det["ped"], 4: n_det["cyc"]}
    assert by_type[2] and by_type[4]
    assert os.path.exists(os.path.join(exp, RECIPE, "checkpoints",
                                       "torch_epoch_0000.pt"))
