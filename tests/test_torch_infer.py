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
from rangedet_tpu_torch.convert import save_npz
from rangedet_tpu_torch.models.detector import run_inference
from tiny import tiny_config
from torch_parity import (
    BOX_ATOL,
    TINY_PORT_CONFIG,
    check_eval_step,
    init_jax,
    perturb,
    port_config,
)

# one intra-op thread per test process: several workers share the cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_eval_step_matches_jax():
    check_eval_step("bhcw", use_pallas_meta=False)


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
