"""The port's serving slice against the JAX package, in f32: the whole eval
step (per-stride inputs, forward, top-k, decode, WNMS), run_inference on
shared logits, the CLI, and the package's independence from jax."""
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rangedet_tpu.data.synthetic import make_batch
from rangedet_tpu.eval.waymo_bin import export_json, load_prediction_pickle
from rangedet_tpu.models.detector import run_inference as jax_run_inference
from rangedet_tpu.train.train_step import build_eval_inputs as jax_inputs
from rangedet_tpu.train.train_step import make_eval_step as jax_eval_step
from rangedet_tpu_torch.convert import save_npz
from rangedet_tpu_torch.infer import build_eval_inputs, make_eval_step
from rangedet_tpu_torch.models.detector import run_inference
from tiny import tiny_config
from torch_parity import init_jax, perturb, port_config, port_model

# one intra-op thread per test process: several workers share the cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOX_ATOL = 1e-3
# scores the two frameworks compute differ by ~1e-7 in f32; candidates
# closer than this to min_score or to each other could flip valid or swap
# greedy order, so the test asserts its inputs keep them apart
SCORE_MARGIN = 1e-3
ORDER_GAP = 1e-6

# tests/tiny.py's overrides for the port's config (no jax import)
TINY_PORT_CONFIG = textwrap.dedent("""
    import torch
    from rangedet_tpu_torch.configs import load_config

    def get_config(is_train):
        return load_config("rangedet_veh_wo_aug_4_18e", is_train).replace(
            feat_size=(16, 128), pad_field=(16, 128), max_gt_boxes=32,
            num_block={"res1": 2, "res2a": 1, "res2": 1, "res3a": 1,
                       "res3": 1, "agg1": 1, "agg2": 1, "agg2a": 1,
                       "agg3": 1},
            num_filter={"res1": 16, "res2a": 16, "res2": 32, "res3a": 32,
                        "res3": 32, "agg1": 16, "agg2": 32, "agg2a": 16,
                        "agg3": 16},
            meta_units={"res1_unit2": dict(channel_list=(8, 16))},
            cls_conv_layers=1, cls_conv_channel=32, reg_conv_layers=1,
            reg_conv_channel=32, device_topk={"veh": 256}, iou_topk_gt=8,
            dtype=torch.float32,
        )
""")


def _masked_logits(model, tbatch):
    with torch.inference_mode():
        logits, _ = model(tbatch["input_data"], tbatch["coord"])
    B = logits[0].shape[0]
    lg = torch.cat([l.reshape(B, -1) for l in logits], 1)
    mask = torch.cat([tbatch[f"mask_s{s}"].reshape(B, -1)
                      for s in (1, 2, 4)], 1)
    return torch.where(mask > 0, lg, torch.full_like(lg, -50.0)).numpy()


def test_eval_step_matches_jax():
    jcfg = tiny_config(is_train=False, layout="bhcw", dtype=jnp.float32)
    batch = make_batch(jcfg, 2, seed=11, num_boxes=6)
    jmodel, v = init_jax(jcfg, batch)
    params, stats = perturb(v, seed=7)
    head = params["head"]
    for lvl in range(3):  # spread the logits so scores are well apart
        head[f"cls_logit_lvl_{lvl}_kernel"] *= 100.0

    # place min_score in a gap of both frames' scores, with the frames'
    # candidate counts apart, so a cap between them truncates one frame
    pcfg = port_config(jcfg)
    tb = build_eval_inputs(batch, pcfg, torch.device("cpu"))
    lg = _masked_logits(port_model(pcfg, params, stats), tb).astype(np.float64)
    desc = np.sort(lg[0])[::-1]
    for i in range(30, 90):
        shift = -0.5 * (desc[i - 1] + desc[i])
        scores = 1 / (1 + np.exp(-(lg + shift)))
        n_valid = (scores > 0.5).sum(axis=1)
        # the trap: scores near min_score would be decided by rounding noise
        if (np.abs(scores - 0.5).min() > SCORE_MARGIN
                and abs(n_valid[1] - n_valid[0]) >= 4):
            break
    else:
        raise AssertionError("no min_score gap clear of both frames' scores")
    for lvl in range(3):
        head[f"cls_logit_lvl_{lvl}_bias"] += np.float32(shift)
    topk = int(min(n_valid) + abs(n_valid[1] - n_valid[0]) // 2)
    jcfg = jcfg.replace(device_topk={"veh": topk})
    pcfg = port_config(jcfg)
    model = port_model(pcfg, params, stats)
    scores = 1 / (1 + np.exp(-_masked_logits(model, tb).astype(np.float64)))
    assert ((scores > 0.5).sum(axis=1) == n_valid).all()
    assert np.abs(scores - 0.5).min() > SCORE_MARGIN
    top = np.sort(scores, axis=1)[:, ::-1][:, : topk + 1]
    assert np.diff(-top, axis=1).min() > ORDER_GAP

    jstep = jax.jit(lambda p, s, b: jax_eval_step(jmodel, jcfg)(
        type("S", (), {"params": p, "batch_stats": s})(),
        jax_inputs(b, jcfg)))
    want = jstep(params, stats, {k: jnp.asarray(x) for k, x in batch.items()})
    got = make_eval_step(model, pcfg)(build_eval_inputs(batch, pcfg,
                                                        torch.device("cpu")))
    w, g = want["veh"], got["veh"]
    np.testing.assert_array_equal(g["truncated"].numpy(),
                                  np.asarray(w["truncated"]))
    assert g["truncated"].numpy().tolist() == [
        bool(n > topk) for n in n_valid]
    gv = g["valid"].numpy()
    np.testing.assert_array_equal(gv, np.asarray(w["valid"]))
    assert gv.sum(axis=1).min() >= 3
    np.testing.assert_allclose(g["boxes"].numpy()[gv],
                               np.asarray(w["boxes"])[gv], atol=BOX_ATOL)


def _fabricate(cfg, n_hot, seed=0):
    """Per-level logits with exactly n_hot above-threshold pixels."""
    r = np.random.RandomState(seed)
    logits, deltas, batch = [], [], {}
    hot_left = n_hot
    for s in cfg.fpn_strides:
        H, W = cfg.feat_size[0], cfg.feat_size[1] // s
        flat = r.uniform(-9.0, -5.0, H * W).astype(np.float32)
        take = min(hot_left, flat.size // 2)
        flat[r.choice(flat.size, take, replace=False)] = r.uniform(
            2.0, 6.0, take)
        hot_left -= take
        logits.append(flat.reshape(1, H, W, 1))
        deltas.append(r.uniform(-0.4, 0.4, (1, H, W, 8)).astype(np.float32))
        batch[f"pc_s{s}"] = r.uniform(-30, 30, (1, H, W, 3)).astype(np.float32)
        batch[f"mask_s{s}"] = (r.uniform(size=(1, H, W, 1)) > 0.1).astype(
            np.float32)
    return logits, deltas, batch


def test_run_inference_matches_jax_on_shared_logits():
    jbase = tiny_config(is_train=False)
    for n_hot, topk in ((150, 256), (700, 256)):  # fits / cap binds
        jcfg = jbase.replace(device_topk={"veh": topk})
        pcfg = port_config(jcfg.replace(dtype=jnp.float32))
        logits, deltas, batch = _fabricate(jcfg, n_hot)
        want = jax.jit(lambda l, d, b: jax_run_inference(l, d, b, jcfg))(
            [jnp.asarray(x) for x in logits], [jnp.asarray(x) for x in deltas],
            {k: jnp.asarray(x) for k, x in batch.items()})["veh"]
        T = torch.from_numpy
        got = run_inference([T(x) for x in logits], [T(x) for x in deltas],
                            {k: T(x) for k, x in batch.items()}, pcfg)["veh"]
        assert bool(got["truncated"][0]) == (n_hot > topk)
        np.testing.assert_array_equal(got["truncated"].numpy(),
                                      np.asarray(want["truncated"]))
        gv = got["valid"].numpy()
        np.testing.assert_array_equal(gv, np.asarray(want["valid"]))
        assert gv.sum() > 10
        np.testing.assert_allclose(got["boxes"].numpy()[gv],
                                   np.asarray(want["boxes"])[gv],
                                   atol=BOX_ATOL)


@pytest.mark.parametrize("weights", [False, True])
def test_cli_writes_a_pickle_the_bin_exporter_reads(tmp_path, weights):
    from rangedet_tpu_torch.tools import test as cli

    cfg_py = tmp_path / "tiny_recipe.py"
    cfg_py.write_text(TINY_PORT_CONFIG)
    args = ["--config", str(cfg_py), "--synthetic", "3", "--batch", "2",
            "--device", "cpu", "--output", str(tmp_path / "pred.pkl")]
    if weights:  # a JAX tree of the same recipe, through the .npz bridge
        jcfg = tiny_config(is_train=False, layout="bhcw")
        _, v = init_jax(jcfg, make_batch(jcfg, 1, seed=0))
        save_npz(str(tmp_path / "w.npz"), *perturb(v, seed=3))
        args += ["--weights", str(tmp_path / "w.npz")]
    out = cli.main(args)
    anno, outputs = load_prediction_pickle(out)
    assert sorted(outputs) == sorted(anno) == [
        f"synthetic_{i}" for i in range(3)]
    for rec in outputs.values():
        det = rec["det_xyzlwhyaws"]["veh"]
        assert det.ndim == 2 and det.shape[1] == 8
        assert np.isfinite(det).all()
        assert isinstance(rec["truncated"], bool)
    n = export_json(out, str(tmp_path / "pred.json"))
    assert n == sum(len(r["det_xyzlwhyaws"]["veh"]) for r in outputs.values())


def test_package_runs_without_jax(tmp_path):
    (tmp_path / "tiny_recipe.py").write_text(TINY_PORT_CONFIG)
    code = textwrap.dedent(f"""
        import sys
        import torch
        from rangedet_tpu_torch.configs import load_config
        from rangedet_tpu_torch.data.synthetic import make_batch
        from rangedet_tpu_torch.infer import build_eval_inputs, make_eval_step
        from rangedet_tpu_torch.models import RangeDet
        import rangedet_tpu_torch.convert, rangedet_tpu_torch.tools.test

        cfg = load_config({str(tmp_path / "tiny_recipe.py")!r}, False)
        model = RangeDet(**cfg.model_kwargs())
        model.init_from(torch.Generator().manual_seed(0))
        out = make_eval_step(model.eval(), cfg)(build_eval_inputs(
            make_batch(cfg, 1, seed=0), cfg, torch.device("cpu")))
        assert out["veh"]["boxes"].shape == (1, 200, 8)
        bad = [m for m in sys.modules if m.split(".")[0] in
               ("jax", "flax", "optax", "rangedet_tpu")]
        assert not bad, bad
        print("OK")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and "OK" in proc.stdout, proc.stderr[-2000:]
