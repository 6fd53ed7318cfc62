"""The plain reference against the program's plain path, on the CPU at a
tiny size in f32: the same weights and batches on both sides. The program
runs its kernels' plain versions here (every op routes a CPU tensor to
them); the reference shares no code with it.

Tolerances: f32 on both sides, the sums in other orders (convs as
F.conv2d against the program's 3x3 conv by taps, the Meta-Kernel block
fused against materialized, the deconv as a transposed conv against four
phase-packed convs): outputs within 1e-4 of their largest value, the
losses within 1e-5 relative, targets and post-processing (the same
arithmetic) within 1e-5 (the boxes within 1e-5 + 1e-6 of their value: a
few ulps of a 70 m coordinate)."""
import json

import pytest
import torch

from portbench import run
from portbench.reference.losses import losses
from portbench.reference.model import Net
from portbench.reference.post import run_inference as ref_inference
from portbench.reference.targets import build_targets
from portbench.reference.train import train_steps
from portbench.traffic.frames import make_pool
from portbench.weights import model_weights

from tiny import TINY, TINY_TRAFFIC

torch.set_num_threads(2)
SEED = 2 ** 31 + 11
CONFIGS = ["rangedet_veh_wo_aug_4_18e", "rangedet_veh_tpuopt_all_36e"]


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


@pytest.fixture(scope="module", params=CONFIGS)
def setup(request):
    config = json.loads((run.ROOT / "portbench" / "configs"
                         / f"{request.param}.json").read_text())
    config["config"].update(TINY)
    if request.param.endswith("tpuopt_all_36e"):
        config["config"]["num_filter"] = {k: 2 * v for k, v in
                                          TINY["num_filter"].items()}
        config["config"]["meta_units"] = {
            "res1_unit2": {"channel_list": [8, 32]}}
    c = config["config"]
    traffic = json.loads((run.ROOT / "portbench" / "traffic"
                          / "train_b2.json").read_text())
    traffic.update(TINY_TRAFFIC)
    dev = torch.device("cpu")
    pool = [run.to_device(b, dev) for b in make_pool(SEED, traffic, c)]
    W = model_weights(c, SEED, dev)
    return config, c, pool, W


def _port_model(config, W, train):
    from rangedet_tpu_torch.models import RangeDet

    cfg = run.port_config(config, train)
    model = RangeDet(**cfg.model_kwargs())
    model.load_state_dict(W, strict=True)
    return cfg, model.train(train)


@pytest.mark.parametrize("train", [True, False])
def test_forward(setup, train):
    config, c, pool, W = setup
    cfg, model = _port_model(config, W, train)
    b = pool[0]
    with torch.no_grad():
        got = model(b["input_data"], b["coord"])
        want = Net(W, c, train=train)(b["input_data"], b["coord"])
    for g, w in zip(got, want):
        for x, y in zip(g, w):
            assert x.shape == y.shape
            assert _rel(x, y) < 1e-4


def test_targets(setup):
    from rangedet_tpu_torch.models.detector import build_train_targets

    config, c, pool, W = setup
    cfg = run.port_config(config, True)
    got = build_train_targets(pool[1], cfg)
    want = build_targets(pool[1], c)
    assert set(got) == set(want)
    for k in got:
        assert torch.allclose(got[k], want[k], atol=1e-5), k
    assert float(want["reg_norm_weight_s1"].sum()) > 0  # boxes were hit


def test_losses(setup):
    from rangedet_tpu_torch.models.detector import (build_train_targets,
                                                     compute_losses)

    config, c, pool, W = setup
    cfg, model = _port_model(config, W, True)
    b = pool[0]
    with torch.no_grad():
        cls, reg = model(b["input_data"], b["coord"])
        total, metrics = compute_losses(cls, reg,
                                        build_train_targets(b, cfg), cfg)
        want, wm = losses(cls, reg, build_targets(b, c), c)
    for k in metrics:
        assert abs(float(metrics[k]) - float(wm[k])) <= 1e-5 * abs(
            float(wm[k])) + 1e-7, k


def test_sgd_steps(setup):
    from rangedet_tpu_torch.train.state import create_train_state
    from rangedet_tpu_torch.train.train_step import build_train_step_fn

    config, c, pool, W = setup
    cfg, model = _port_model(config, W, True)
    spe = config["assumed"]["steps_per_epoch"]
    state = create_train_state(model, cfg, spe, seed=None)
    step = build_train_step_fn(state, cfg)
    got = [float(step(b)["total_loss"]) for b in pool[:2]]
    ref = train_steps(W, c, spe, pool[:2])
    for a, b in zip(got, ref["losses"]):
        assert abs(a - b) <= 1e-5 * abs(b)
    rels = [_rel(p.detach() - W[n], ref["params"][n] - W[n])
            for n, p in model.named_parameters()]
    assert max(sorted(rels)[:len(rels) // 2]) < 1e-3  # the median leaf
    assert max(rels) < 5e-2  # relu masks flipped by rounding, a few pixels


def test_post_processing(setup):
    from rangedet_tpu_torch.infer import build_eval_inputs
    from rangedet_tpu_torch.models.detector import run_inference

    config, c, pool, W = setup
    cfg, model = _port_model(config, W, False)
    batch = build_eval_inputs(pool[2], cfg, torch.device("cpu"))
    with torch.no_grad():
        cls, reg = model(batch["input_data"], batch["coord"])
        got = run_inference(cls, reg, batch, cfg)
    s = c["fpn_strides"]
    want = ref_inference(cls, reg, [batch[f"pc_s{i}"] for i in s],
                         [batch[f"mask_s{i}"] for i in s], c)
    for name, r in want.items():
        assert torch.equal(got[name]["valid"], r["valid"])
        assert int(r["valid"].sum()) > 0
        v = r["valid"]
        ref = r["boxes"][v]
        assert bool(((got[name]["boxes"][v] - ref).abs()
                     <= 1e-5 + 1e-6 * ref.abs()).all())
        assert torch.equal(got[name]["truncated"], r["truncated"])
