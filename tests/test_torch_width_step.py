"""The port's width-sharded train step (``train_step.build_train_step_fn``
with a width group: halos over it, sync BatchNorm and the reduction over
the world, the targets' per-box point counts over the width group) on the
CPU in f32: two gloo ranks on {"model": 2} (one spawn for the module,
``chip_smoke.rank_main``; its four runs share the processes), each with
half of the columns of a B=2 batch, against JAX's width step
(``build_train_step_fn`` with ``width_axis="model"`` on a {"data": 1,
"model": 2} mesh) and against the port's one-process step, under the
tolerances of tests/test_torch_train.py (losses, updated parameters and
running statistics); both ranks end bit-equal; the collectives a step;
three planted faults (``chip_smoke.planted``) fail those gates: the
forward's halo zeros, the backward dropping the returned halo gradient,
the point counts not summed over the width group, the last only after
the batch is shown to hold a box across the seam.

The small config is tests/torch_dp.py's at 5x128: at 5x64 a shard would
be 2 columns wide at stride 16, and the deconv there takes a 4-column halo
(JAX's width path as much as the port's)."""
from unittest import mock

import jax
import numpy as np
import pytest
import torch

import chip_smoke
import torch_dp as D
from rangedet_tpu.models import RangeDet as JaxRangeDet
from rangedet_tpu.parallel import make_mesh, replicate_state, shard_batch
from rangedet_tpu.train.schedule import build_optimizer as jax_optimizer
from rangedet_tpu.train.state import TrainState
from rangedet_tpu.train.train_step import build_train_step_fn as jax_step_fn
from rangedet_tpu_torch.convert import from_flax
from rangedet_tpu_torch.models import RangeDet, layers
from rangedet_tpu_torch.train import train_step
from rangedet_tpu_torch.train.state import create_train_state
from torch_parity import port_config

torch.set_num_threads(1)

FAULTS = ("halo_zeros", "halo_grad", "counts")
MESH = {"data": 1, "model": 2}


def width_cfg():
    return D.small_cfg(use_pallas_meta=True).replace(feat_size=(5, 128),
                                                     pad_field=(5, 128))


def jax_width_step(jcfg, params, stats, batch):
    """One step of JAX's width step on {"data": 1, "model": 2}. ->
    (metrics as floats, params, batch_stats as numpy trees)."""
    mesh = make_mesh(MESH)
    cfg = jcfg.replace(width_axis="model",
                       bn_sync_axis=tuple(mesh.axis_names))
    model = JaxRangeDet(**cfg.model_kwargs())
    tx, _ = jax_optimizer(cfg, D.STEPS_PER_EPOCH)
    state = replicate_state(TrainState.create(
        apply_fn=model.apply, params=params, batch_stats=stats, tx=tx), mesh)
    flag = "jax_disable_most_optimizations"
    before = jax.config.read(flag)
    jax.config.update(flag, True)
    try:
        fn = jax_step_fn(model, cfg, mesh)
        assert fn.bn_semantics == "sync"
        state, m = jax.jit(fn)(state, shard_batch(batch, mesh))
    finally:
        jax.config.update(flag, before)
    return ({k: float(v) for k, v in m.items()},
            jax.tree_util.tree_map(np.asarray, state.params),
            jax.tree_util.tree_map(np.asarray, state.batch_stats))


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    jcfg = width_cfg()
    params, stats, batch = D.weights_and_batch(jcfg)
    init = from_flax(params, stats)
    runs = [dict(name="honest")] + [dict(name=f, plant=f) for f in FAULTS]
    handle = D.start_ranks(D.port_ranks_spec(jcfg, init, batch, "sync",
                                             mesh=MESH, runs=runs),
                           tmp_path_factory.mktemp("width_step"), "width")
    try:  # the ranks run while JAX compiles its step
        jm, jp, js = jax_width_step(jcfg, params, stats, batch)
        one = D.port_one_process(jcfg, init, batch)
    finally:
        ranks = D.wait_ranks(handle)
    return dict(init=init, jax=(jm, from_flax(jp, js)), one=one,
                ranks=ranks, batch=batch, cfg=port_config(jcfg))


def passes(run, ref, init):
    """The gates of tests/test_torch_train.py: losses within LOSS_TOL,
    the updates within UPDATE_TOL (max) and UPDATE_MEDIAN_TOL (median)."""
    got = run["metrics"][0]
    losses = all(np.isclose(got[k], ref[0][k], **D.LOSS_TOL) for k in ref[0])
    return losses and D.within_gates(D.update_rels(run["states"][0], ref[1],
                                                   init))


def test_the_batch_has_a_box_across_the_seam(case):
    # the counts fault shows only where a box has points in both shards
    assert chip_smoke.seam_boxes(torch, case["batch"], MESH["model"])


def test_width_losses_match_jax_and_one_process(case):
    for r in case["ranks"]:
        assert r["honest"]["bn_semantics"] == "sync"
        D.assert_metrics_close(r["honest"]["metrics"][0], case["jax"][0])
        D.assert_metrics_close(r["honest"]["metrics"][0], case["one"][0])


@pytest.mark.parametrize("ref", ["jax", "one"])
def test_width_updates_match(case, ref):
    got = case["ranks"][0]["honest"]["states"][0]
    D.assert_within_gates(D.update_rels(got, case[ref][1], case["init"]))


def test_both_ranks_end_bit_equal(case):
    for name in ("honest",) + FAULTS:
        a, b = (r[name] for r in case["ranks"])
        assert a["metrics"] == b["metrics"], name
        assert all(torch.equal(v, b["states"][0][k])
                   for k, v in a["states"][0].items()), name


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_fault_fails_the_gates(case, fault):
    if fault == "counts":
        test_the_batch_has_a_box_across_the_seam(case)
    honest = case["ranks"][0]["honest"]
    run = case["ranks"][0][fault]
    for ref in ("jax", "one"):
        assert passes(honest, case[ref], case["init"])
        assert not passes(run, case[ref], case["init"]), (fault, ref)


def halo_exchanges(model):
    """(forward, backward) halo exchanges of a step of ``model``: one a 3x3
    conv or deconv, two for the Meta-Kernel (features and coordinates);
    no backward for the first conv (its input is the data) or for the
    coordinates."""
    convs = sum(isinstance(m, layers.ConvNormRelu) and m.kernel == 3
                or isinstance(m, layers.DeconvNormRelu)
                for m in model.modules())
    convs += sum(hasattr(m, "conv2_weight") for m in model.modules())
    metas = sum(hasattr(m, "mlp0") for m in model.modules())
    return convs + 2 * metas, convs + metas - 1


def test_collectives_a_step(case):
    # each BatchNorm's means forward and their cotangent backward, the
    # halo exchanges, the point counts of each frame, the level's two loss
    # normalizers, one flat buffer of the gradients and metrics, one of the
    # running statistics
    model = RangeDet(**case["cfg"].model_kwargs())
    n_bn = sum(isinstance(m, layers.BatchNormFold) for m in model.modules())
    fwd, bwd = halo_exchanges(model)
    frames = case["batch"]["pc"].shape[0]
    for r in case["ranks"]:
        assert r["honest"]["collectives"] == [
            2 * n_bn + fwd + bwd + frames + 2 + 2]
        assert r["halo_zeros"]["collectives"] == [2 * n_bn + bwd + frames + 4]
        assert r["halo_grad"]["collectives"] == [2 * n_bn + fwd + frames + 4]
        assert r["counts"]["collectives"] == [2 * n_bn + fwd + bwd + 4]


def test_width_step_selector_checks_the_groups():
    cfg = port_config(width_cfg()).replace(width_axis="model")
    model = RangeDet(**cfg.model_kwargs())
    state = create_train_state(model, cfg, 10, seed=0)
    world, width = object(), object()
    with mock.patch("torch.distributed.get_world_size", return_value=2):
        with pytest.raises(ValueError, match="set_sync_group"):
            train_step.build_train_step_fn(state, cfg, world, width)
        layers.set_sync_group(model, world)
        with pytest.raises(ValueError, match="set_width_group"):
            train_step.build_train_step_fn(state, cfg, world, width)
        layers.set_width_group(model, width)
        with pytest.raises(ValueError, match="sync BatchNorm"):
            train_step.build_train_step_fn(
                state, cfg.replace(sync_bn=False), world, width)
        with pytest.raises(ValueError, match="width_axis"):
            train_step.build_train_step_fn(
                state, cfg.replace(width_axis=None), world, width)
        assert train_step.build_train_step_fn(
            state, cfg, world, width).bn_semantics == "sync"
    # the fused block is off under width sharding, as JAX's
    block = model.backbone.res1.res1_unit2.meta_block
    assert block.training and block.use_pallas_meta and not block.fused
    with layers.without_width(model):
        assert block.fused
    assert layers.width_groups(model) == {width}
