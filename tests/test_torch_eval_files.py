"""The port's serving path from dataset files against the JAX package, on
the CPU at the tiny config: roidb/npz input (data/waymo.py), the AP
evaluator (eval/ap.py), checkpoints (train/checkpoint.py), and the CLIs
test -> evaluate_pred / create_prediction_bin_3d, train -> eval_checkpoint.
Fixture frames come from the port's seeded data/synthetic.py, written in the
offline builder's format with holes, a no-label-zone strip and two
classes."""
import contextlib
import io
import json
import math
import os
import pickle

import numpy as np
import pytest
import torch

from rangedet_tpu.data import waymo as jwaymo
from rangedet_tpu.eval import ap as jap
from rangedet_tpu.train import checkpoint as jckpt
from rangedet_tpu_torch.configs import load_config
from rangedet_tpu_torch.data import waymo as twaymo
from rangedet_tpu_torch.data.synthetic import write_waymo_files
from rangedet_tpu_torch.eval import ap as tap
from rangedet_tpu_torch.models import RangeDet
from rangedet_tpu_torch.train import checkpoint as tckpt
from rangedet_tpu_torch.train.state import create_train_state
from torch_parity import TINY_PORT_CONFIG

# one intra-op thread per test process: several workers share the cores
torch.set_num_threads(1)

H, W = 16, 128  # the tiny config's feat_size and pad_field
N_FRAMES = 5


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Fixture dataset, tiny recipe file and experiment dir, shared by the
    module's tests."""
    root = tmp_path_factory.mktemp("eval_files")
    recs = write_waymo_files(str(root / "data"), N_FRAMES, H=H, W=W, seed=3,
                             num_boxes=6, class_choices=(1, 2))
    recipe = root / "tiny_recipe.py"
    recipe.write_text(TINY_PORT_CONFIG)
    return dict(root=root, data=str(root / "data"), recipe=str(recipe),
                recs=recs, exp=str(root / "exp"))


# ---------------------------------------------------------------- (e)
@pytest.mark.parametrize("sampling_rate,filter_class", [
    (1, None), (2, ("TYPE_VEHICLE",)), (1, ("TYPE_PEDESTRIAN",))])
def test_roidb_input_matches_jax(files, sampling_rate, filter_class):
    got = twaymo.load_roidbs(files["data"], ("validation",), sampling_rate,
                             filter_class)
    want = jwaymo.load_roidbs(files["data"], ("validation",), sampling_rate,
                              filter_class)
    assert len(got) == len(want) == len(files["recs"][::sampling_rate])
    holes = nlz = 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in ("gt_class", "gt_bbox_csa", "points_in_box"):
            np.testing.assert_array_equal(g[k], w[k])
        if filter_class:
            keep = {twaymo.WAYMO_TYPE[c] for c in filter_class}
            assert set(np.unique(g["gt_class"])) <= keep
        gi = twaymo.record_to_inputs(g, (H, W), 32)
        wi = jwaymo.record_to_inputs(w, (H, W), 32)
        assert sorted(gi) == sorted(wi)
        for k in gi:
            assert gi[k].dtype == wi[k].dtype, k
            np.testing.assert_array_equal(gi[k], wi[k], err_msg=k)
        with np.load(g["pc_url"]) as npz:
            holes += int((npz["range_image"][..., 0] == -1).sum())
        nlz += int((gi["is_in_nlz"] > 0).sum())
    assert holes > 0 and nlz > 0  # the fixture exercises both


# ---------------------------------------------------------------- (f)
def _ap_frames(seed, n=6):
    """Seeded detection/GT frames: GTs at 5-70 m with point counts (some
    0 and <= 5, for LEVEL_2 and the excluded), detections jittered from
    them plus false positives; one frame without GTs, one without
    detections."""
    r = np.random.RandomState(seed)
    frames = []
    for i in range(n):
        m = 0 if i == 1 else r.randint(3, 9)
        ang, dist = r.uniform(-np.pi, np.pi, m), r.uniform(5, 70, m)
        gt = np.stack([dist * np.cos(ang), dist * np.sin(ang),
                       r.uniform(-1, 1, m), r.uniform(3.5, 5, m),
                       r.uniform(1.6, 2.1, m), r.uniform(1.4, 1.8, m),
                       r.uniform(-np.pi, np.pi, m)], -1).astype(np.float32)
        det = gt + (r.normal(0, 0.25, gt.shape)
                    * np.float32([1, 1, 0.3, 0.3, 0.1, 0.1, 0.3]))
        fp = gt[r.randint(0, max(m, 1), 2)] if m else np.zeros((0, 7))
        fp = fp + np.float32([6, -6, 0, 0, 0, 0, 1])
        det = np.concatenate([det, fp]).astype(np.float32)
        if i == 2:
            det = det[:0]
        frames.append(dict(
            det_csa=det, det_scores=r.uniform(0.3, 1, len(det)).astype(
                np.float32),
            gt_csa=gt,
            gt_num_points=r.choice([0, 3, 5, 40, 200], m).astype(np.float32)))
    return frames


@pytest.mark.parametrize("mode", ["3d", "bev"])
def test_ap_matches_jax(mode):
    frames = _ap_frames(7)
    for iou in (0.7, 0.5):
        for fn in ("average_precision", "waymo_metrics", "range_breakdown"):
            got = getattr(tap, fn)(frames, iou_thresh=iou, mode=mode)
            want = getattr(jap, fn)(frames, iou_thresh=iou, mode=mode)
            assert got == want, (fn, iou)
    # the frames are no trivial case: some matches, not all
    ap = tap.waymo_metrics(frames, iou_thresh=0.5, mode=mode)["L2"]
    assert 0.1 < ap["ap"] < 1.0


# ---------------------------------------------------------------- (g)
@pytest.fixture(scope="module")
def chain(files):
    """train one epoch of 2 steps -> checkpoint epoch 0; test from the
    roidb at that epoch -> pickle. Returns (train state, pickle path,
    test's stdout)."""
    from rangedet_tpu_torch.tools import test as test_cli
    from rangedet_tpu_torch.tools import train as train_cli

    with contextlib.redirect_stdout(io.StringIO()):
        _, state, _ = train_cli.main([
            "--config", files["recipe"], "--synthetic", "--epochs", "1",
            "--steps-per-epoch", "2",
            "--experiment-dir", files["exp"], "--device", "cpu"])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        pred = test_cli.main([
            "--config", files["recipe"], "--data-root", files["data"],
            "--image-set", "validation", "--batch", "2", "--experiment-dir",
            files["exp"], "--epoch", "0", "--device", "cpu", "--output",
            str(files["root"] / "pred.pkl")])
    return state, pred, out.getvalue()


def _jax_records(pred, cfg, iou, mode):
    """What tools/evaluate_pred.py prints, from the JAX evaluator."""
    from rangedet_tpu_torch.tools.evaluate_pred import load_frames

    per_class = load_frames(pred, cfg.class_names,
                            dict(zip(cfg.class_names, cfg.label_set)))
    out = []
    for c in cfg.class_names:
        wod = jap.waymo_metrics(per_class[c], iou_thresh=iou, mode=mode)
        rec = {"class": c, "iou": iou, "mode": mode,
               "frames": len(per_class[c]),
               "l1_ap": round(wod["L1"]["ap"], 4),
               "l1_aph": round(wod["L1"]["aph"], 4),
               "l2_ap": round(wod["L2"]["ap"], 4),
               "l2_aph": round(wod["L2"]["aph"], 4),
               "l1_recall": round(wod["L1"]["recall"], 4)}
        rb = jap.range_breakdown(per_class[c], iou_thresh=iou, mode=mode)
        rec.update({f"l1_ap_r{k}": round(r["ap"], 4) for k, r in rb.items()})
        out.append(rec)
    return out


def test_dataset_chain_test_evaluate_export(files, chain):
    from rangedet_tpu.eval.waymo_bin import load_prediction_pickle
    from rangedet_tpu_torch.tools import create_prediction_bin_3d
    from rangedet_tpu_torch.tools import evaluate_pred

    _, pred, out = chain
    assert "checkpoint epoch 0" in out
    anno, outputs = load_prediction_pickle(pred)
    ids = [r["rec_id"] for r in files["recs"]]
    assert sorted(outputs) == sorted(anno) == sorted(ids)
    for rec in files["recs"]:
        a = anno[rec["rec_id"]]
        np.testing.assert_array_equal(a["gt_bbox_csa"], rec["gt_bbox_csa"])
        assert a["meta_info"] == rec["meta_info"]
        assert outputs[rec["rec_id"]]["meta_info"] == rec["meta_info"]
        det = outputs[rec["rec_id"]]["det_xyzlwhyaws"]["veh"]
        assert det.ndim == 2 and det.shape[1] == 8 and np.isfinite(det).all()

    # a second pickle whose detections match the GTs, so the AP is no 0
    r = np.random.RandomState(0)
    hit = {}
    for rid, o in outputs.items():
        gt = anno[rid]["gt_bbox_csa"][anno[rid]["gt_class"] == 1]
        near = gt + r.normal(0, 0.1, gt.shape).astype(np.float32)
        sc = r.uniform(0.5, 1, (len(gt), 1)).astype(np.float32)
        hit[rid] = dict(o, det_xyzlwhyaws={"veh": np.concatenate(
            [np.concatenate([near, sc], 1), o["det_xyzlwhyaws"]["veh"]])})
    pred_hit = str(files["root"] / "pred_hit.pkl")
    with open(pred_hit, "wb") as f:
        pickle.dump(anno, f)
        pickle.dump(hit, f)

    cfg = load_config(files["recipe"], is_train=False)
    for path, mode in ((pred, "3d"), (pred_hit, "3d"), (pred_hit, "bev")):
        got = evaluate_pred.main(["--config", files["recipe"], "--pred", path,
                                  "--mode", mode, "--buckets"])
        assert got == _jax_records(path, cfg, cfg.eval_iou_thresh["veh"],
                                   mode)
        assert got[0]["frames"] == N_FRAMES
    assert got[0]["l2_ap"] > 0.2
    n = create_prediction_bin_3d.main(["--pred", pred, "--out",
                                       str(files["root"] / "pred.json")])
    with open(files["root"] / "pred.json") as f:
        assert len(json.load(f)) == n == sum(
            len(o["det_xyzlwhyaws"]["veh"]) for o in outputs.values())


def test_checkpoints_round_trip_and_keep_apart_from_jax(files, tmp_path):
    cfg = load_config(files["recipe"], is_train=True).replace(
        experiment_dir=str(tmp_path))
    model = RangeDet(**cfg.model_kwargs())
    state = create_train_state(model, cfg, 10, seed=0)
    for p in model.parameters():  # momentum buffers to save
        p.grad = torch.randn_like(p)
    state.optimizer.step()
    state.step = 7
    assert tckpt.latest_epoch(cfg) is None
    for epoch in (0, 2):
        tckpt.save_checkpoint(state, cfg, epoch)
    # an orbax checkpoint of the JAX package in the same directory
    jckpt.save_checkpoint({"w": np.arange(3.0)}, cfg, 5)
    assert sorted(os.listdir(tckpt.checkpoint_dir(cfg))) == [
        "epoch_0005", "torch_epoch_0000.pt", "torch_epoch_0002.pt"]
    assert tckpt.latest_epoch(cfg) == 2
    assert jckpt.latest_epoch(cfg) == 5
    jstate, jep = jckpt.restore_checkpoint({"w": np.zeros(3)}, cfg)
    assert jep == 5 and np.asarray(jstate["w"]).tolist() == [0.0, 1.0, 2.0]

    fresh = create_train_state(RangeDet(**cfg.model_kwargs()), cfg, 10,
                               seed=1)
    fresh, ep = tckpt.restore_checkpoint(fresh, cfg)
    assert ep == 2 and fresh.step == 7
    want, got = state.model.state_dict(), fresh.model.state_dict()
    assert sorted(want) == sorted(got)
    assert all(torch.equal(want[k], got[k]) for k in want)
    wo, go = state.optimizer.state_dict(), fresh.optimizer.state_dict()
    assert wo["param_groups"] == go["param_groups"]
    assert sorted(wo["state"]) == sorted(go["state"])
    for k in wo["state"]:
        assert torch.equal(wo["state"][k]["momentum_buffer"],
                           go["state"][k]["momentum_buffer"])


def test_train_checkpoint_restores_the_model_and_eval_checkpoint_scores_it(
        files, chain, capsys):
    from rangedet_tpu_torch.infer import build_eval_inputs, make_eval_step
    from rangedet_tpu_torch.tools import eval_checkpoint

    state = chain[0]
    cfg = load_config(files["recipe"], is_train=False).replace(
        experiment_dir=files["exp"])
    restored = RangeDet(**cfg.model_kwargs())
    _, ep = tckpt.restore_checkpoint(restored, cfg)
    assert ep == 0
    rec = twaymo.load_roidbs(files["data"], "validation")[0]
    batch = {k: v[None] for k, v in
             twaymo.record_to_inputs(rec, (H, W), 32).items()}
    outs = [make_eval_step(m.eval(), cfg)(build_eval_inputs(
        batch, cfg, torch.device("cpu"))) for m in (state.model, restored)]
    for k in ("boxes", "valid", "truncated"):
        assert torch.equal(outs[0]["veh"][k], outs[1]["veh"][k]), k

    records = eval_checkpoint.main([
        "--config", files["recipe"], "--experiment-dir", files["exp"],
        "--data-root", files["data"], "--n-frames", "3", "--min-scores",
        "0.5,0.1", "--ious", "0.7,0.3", "--device", "cpu"])
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()
             if s.startswith("{")]
    assert lines == records and len(lines) == 4
    for line in lines:
        assert line["epoch"] == 0
        for m in line["metrics"].values():
            assert all(math.isfinite(v) for v in m.values())
