"""The port's on-device raytracer (data/synthetic_device.py), its training
probes (tools/quality_probe.py, tools/overfit_probe.py) and its FLOP count
(tools/flops.py) against the JAX package's, on the CPU at a tiny size: the
renderer fed the draws JAX's make_batch_device makes from its own keys
(vehicles, pedestrians, mixed families, clutter at far range) within 1e-5
with the face pixels that flip counted, the census invariants, the probes'
records and segment rules on a tiny recipe file, and the FLOP count equal
to tools/flops.py's output."""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from rangedet_tpu.data.synthetic_device import make_batch_device as jax_render
from rangedet_tpu_torch.data import synthetic_device as sd
from rangedet_tpu_torch.ops import assigner, boxes
from rangedet_tpu_torch.tools import flops, overfit_probe, quality_probe
from torch_parity import TINY_PORT_CONFIG

# one intra-op thread per test process: several workers share the cores
torch.set_num_threads(1)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
B, H, W, PAD_W, MAX_GT, M = 2, 32, 256, 288, 16, 5
REL_TOL = 1e-5
# pixels whose ray grazes a box face (t_exit ~ t_enter) or ties with the
# wall may flip between the frameworks' last bits; none did at these seeds
FACE_FLIP_MAX = 2
SCENES = {
    "veh": (dict(dims=sd.VEHICLE_DIMS), 0),
    "ped": (dict(dims=sd.PED_DIMS, r_range=(5.0, 25.0), class_value=2.0),
            0),
    "mixed": (dict(families=((sd.VEHICLE_DIMS, (8.0, 40.0), 1.0),
                             (sd.PED_DIMS, (5.0, 25.0), 2.0),
                             (sd.CYC_DIMS, (5.0, 30.0), 4.0))), 0),
    "clutter_far": (dict(dims=sd.VEHICLE_DIMS, r_range=(8.0, 68.0)), 6),
}
INT_DRAWS = ("fam", "row", "c_fam", "c_row")


def jax_draws(key, n_fam, C):
    """The draws of JAX's make_batch_device under ``key``: per frame
    split(key, 14), the clutter's from split(ks[7], 5), as its one_frame
    draws them."""
    u, ri = jax.random.uniform, jax.random.randint
    f32 = jnp.float32
    frames = []
    for k in jax.random.split(key, B):
        ks = jax.random.split(k, 14)
        d = dict(bg_row=u(ks[0], (H, 1), f32, 25.0, 75.0),
                 bg_noise=u(ks[1], (H, W), f32, -2.0, 2.0),
                 drop_u=u(ks[2], (H, W)),
                 fam=ri(ks[3], (M,), 0, n_fam),
                 u=u(ks[6], (M, 4), f32),
                 az_c=u(ks[4], (M,), f32, -jnp.pi * 0.9, jnp.pi * 0.9),
                 row=ri(ks[5], (M,), H // 4, 3 * H // 4),
                 yaw=u(ks[9], (M,), f32, -jnp.pi / 2, jnp.pi / 2),
                 wall_gap=u(ks[10], (M + C,), f32, 2.0, 8.0),
                 int_obj=u(ks[11], (H, W), f32, 0.4, 1.0),
                 int_bg=u(ks[12], (H, W), f32, 0.0, 0.4),
                 elong=u(ks[13], (H, W), f32, 0.0, 0.3))
        if C:
            kc = jax.random.split(ks[7], 5)
            d.update(c_fam=ri(kc[0], (C,), 0, len(sd.CLUTTER_DIMS)),
                     c_u=u(kc[1], (C, 4), f32),
                     c_az=u(kc[2], (C,), f32, -jnp.pi * 0.9, jnp.pi * 0.9),
                     c_row=ri(kc[3], (C,), H // 4, 3 * H // 4),
                     c_yaw=u(kc[4], (C,), f32, -jnp.pi / 2, jnp.pi / 2))
        frames.append(d)
    return {k: torch.from_numpy(np.stack([np.asarray(f[k]) for f in frames]))
            .to(torch.int64 if k in INT_DRAWS else torch.float32)
            for k in frames[0]}


def census(batch, f):
    """The assigner's per-box point counts of frame f."""
    idx = assigner.assign_points_to_boxes(
        batch["pc"][f].reshape(-1, 3),
        boxes.csa_to_corners3d(batch["gt_csa"][f]),
        batch["mask"][f].reshape(-1), box_valid=batch["gt_valid"][f])
    return assigner.points_per_box(idx, MAX_GT)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_render_matches_jax_on_jax_draws(name):
    kw, C = SCENES[name]
    key = jax.random.PRNGKey(11)
    want = {k: np.asarray(v) for k, v in jax_render(
        key, B=B, H=H, W=W, pad_w=PAD_W, max_gt=MAX_GT, num_boxes=M,
        num_clutter=C, **kw).items()}
    n_fam = len(kw.get("families", (None,)))
    got = sd.render_scenes(jax_draws(key, n_fam, C), H, W, PAD_W, MAX_GT,
                           num_boxes=M, num_clutter=C, **kw)
    got = {k: v.numpy() for k, v in got.items()}
    assert sorted(got) == sorted(want)
    flips, zero_az, bad = chip_smoke.render_diff(got, want, REL_TOL)
    assert not bad and flips <= FACE_FLIP_MAX, (bad, flips)
    # a dropped pixel's point is 0: its azimuth is atan2 of signed zeros,
    # which follow the sign of cos(azimuth) where it crosses 0 (one column)
    assert zero_az <= B * H, zero_az
    if flips == 0:  # then the census equals JAX's too
        np.testing.assert_array_equal(got["gt_num_points"],
                                      want["gt_num_points"])


@pytest.mark.parametrize("name", sorted(SCENES))
def test_census_invariants_of_generator_scenes(name):
    kw, C = SCENES[name]
    b = sd.make_batch_device(torch.Generator().manual_seed(3), B=B, H=H,
                             W=W, pad_w=PAD_W, max_gt=MAX_GT, num_boxes=M,
                             num_clutter=C, **kw)
    assert torch.isfinite(b["input_data"]).all()
    for f in range(B):
        counts = census(b, f)
        assert torch.equal(counts, b["gt_num_points"][f]), f
        assert counts[:M].sum() > 0
        gt = b["gt_csa"][f][:M]
        assert (gt[:, 3] > gt[:, 4]).all()  # l > w: yaw identifiable
    if C:  # clutter never enters the GT
        assert (b["gt_valid"].sum(1) == M).all()


def _recipe(tmp_path):
    path = tmp_path / "tiny_recipe.py"
    path.write_text(TINY_PORT_CONFIG)
    return str(path)


def _probe(recipe, *extra):
    return quality_probe.main([
        "--config", recipe, "--device", "cpu", "--steps", "3",
        "--log-every", "2", "--eval-every", "100", "--holdout-frames", "2",
        "--eval-batch", "2", "--boxes", "4", "--warmup-steps", "1",
        *extra])


def test_quality_probe_segment_rules(tmp_path, capsys):
    """tests/test_quality_probe.py's rules: a segment's last step logs and
    evals whatever --log-every is, --step0 / --resume / --save chain the
    segments, the horizon's eval adds the RANGE buckets, and --stop-after
    0 --resume only rescores the saved model."""
    recipe, save = _recipe(tmp_path), str(tmp_path / "probe.pt")
    recs = _probe(recipe, "--stop-after", "2", "--save", save)
    steps = [r for r in recs if "step" in r]
    assert [r["step"] for r in steps] == [2]
    assert any(k.startswith("l1_ap") for k in steps[-1]), steps[-1]
    assert recs[-2] == {"saved": save} and recs[-1]["done"]
    assert all(np.isfinite(v) for v in steps[-1].values())
    recs = _probe(recipe, "--stop-after", "1", "--step0", "2", "--resume",
                  save, "--save", save)
    steps = [r for r in recs if "step" in r]
    assert [r["step"] for r in steps] == [3]
    last = steps[-1]
    assert all(k in last for k in (
        "bev_ap_05", "l1_ap_07", "l1_aph_07", "l2_ap_07", "l2_aph_07",
        "l1_ap_05", "l1_recall_07", "loss", "s_per_step"))
    assert any("_r[" in k for k in last), last  # RANGE buckets
    recs = _probe(recipe, "--stop-after", "0", "--step0", "3", "--resume",
                  save)
    steps = [r for r in recs if "step" in r]
    assert len(steps) == 1 and steps[0]["step"] == 3
    assert "loss" not in steps[0]
    # the saved model rescored: the AP keys of the segment's last record
    assert {k: v for k, v in steps[0].items() if k != "step"} == {
        k: v for k, v in last.items() if k.startswith(("bev_", "l1_", "l2_"))}
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert sum(1 for x in lines if "step" in x) == 3


def test_quality_probe_resume_restores_the_saved_state(tmp_path):
    """--resume restores the model's parameters and buffers, the
    optimizer's state and the step count bit for bit: a rescore saves the
    file it read, and 2 steps + a resumed step end where 3 unbroken steps
    end, with the same step-3 losses (the AP keys are 0 at random weights
    and cannot tell)."""
    recipe = _recipe(tmp_path)
    f = {k: str(tmp_path / f"{k}.pt") for k in ("full", "s2", "s3", "s4",
                                                  "fresh")}
    full = _probe(recipe, "--save", f["full"])
    _probe(recipe, "--stop-after", "2", "--save", f["s2"])
    chain = _probe(recipe, "--stop-after", "1", "--step0", "2", "--resume",
                   f["s2"], "--save", f["s3"])
    _probe(recipe, "--stop-after", "0", "--step0", "3", "--resume", f["s3"],
           "--save", f["s4"])
    _probe(recipe, "--stop-after", "0", "--save", f["fresh"])
    assert chip_smoke.saved_state_diff(f["s3"], f["s4"]) == []
    assert chip_smoke.saved_state_diff(f["full"], f["s3"]) == []

    def step3(recs):
        (r,) = [r for r in recs if r.get("step") == 3]
        return {k: v for k, v in r.items() if k != "s_per_step"}

    assert step3(full) == step3(chain)
    # the check sees a resume that restores nothing, or an earlier state:
    # the model, the optimizer's state and the step count all moved
    for other in ("s2", "fresh"):
        diff = chip_smoke.saved_state_diff(f[other], f["s3"])
        assert "step" in diff, other
        assert any(k.startswith("model/") for k in diff), other
        assert any(k.startswith("optimizer/state/") for k in diff), other


def test_overfit_probe_runs(tmp_path):
    recs = overfit_probe.main([
        "--config", _recipe(tmp_path), "--device", "cpu", "--steps", "3",
        "--log-every", "1", "--eval-every", "3", "--boxes", "4",
        "--style", "vehicles"])
    steps = [r for r in recs if "step" in r]
    assert [r["step"] for r in steps] == [1, 2, 3]
    assert all(np.isfinite(r["loss"]) for r in steps)
    assert sorted(steps[-1]) == sorted([
        "step", "loss", "s_per_step", "bev_ap_05", "bev_recall", "ap3d_07",
        "recall3d_07", "l1_ap", "l1_aph"])
    assert recs[-1]["done"]


def test_flops_equal_the_jax_tool(capsys):
    out = subprocess.run([sys.executable, os.path.join(REPO, "tools",
                                                       "flops.py")],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.splitlines()
    flops.main()
    mine = capsys.readouterr().out.splitlines()
    assert mine == out
    assert json.loads(mine[-1]) == flops.totals()
    assert list(flops.parts()) == [line.split()[0] for line in out[:-1]]
    assert "jax" not in open(flops.__file__).read()
