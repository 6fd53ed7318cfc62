"""The port's data-parallel train step (``make_train_step`` with a group,
its reduction in ``parallel/dp_step.py``) in sync mode, the materialized
Meta-Kernel block, on the CPU: two gloo ranks, each B=1 of one B=2 batch,
against JAX's shard_map step on {"data": 2} with bn_sync_axis="data" and
against the port's one-process B=2 step (losses, updated parameters,
running statistics; tests/test_torch_train.py's tolerances), both ranks
bit-equal; the same step with the BatchNorms' all-reduce detached in the
backward, wholly or by half, fails the parameter gate while its losses
stay right; a group of one is the plain step bit for bit (with the fused
block and with remat too)."""
from unittest import mock

import pytest
import torch

import chip_smoke
import torch_dp as D
from rangedet_tpu_torch.convert import from_flax
from rangedet_tpu_torch.models import RangeDet, layers
from rangedet_tpu_torch.ops import conv3x3, iou_target, meta_block
from rangedet_tpu_torch.ops import meta_kernel
from rangedet_tpu_torch.parallel import dist as pdist
from rangedet_tpu_torch.train import train_step
from rangedet_tpu_torch.train.state import create_train_state
from torch_parity import port_config

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    jcfg = D.small_cfg(use_pallas_meta=False)
    params, stats, batch = D.weights_and_batch(jcfg)
    init = from_flax(params, stats)
    tmp = tmp_path_factory.mktemp("dp_sync")
    # the ranks run while JAX compiles its step
    h_sync = D.start_ranks(D.port_ranks_spec(jcfg, init, batch, "sync"),
                           tmp, "sync")
    h_fault = D.start_ranks(D.port_ranks_spec(jcfg, init, batch, "sync",
                                              fault=True), tmp, "fault")
    h_half = D.start_ranks(D.port_ranks_spec(jcfg, init, batch, "sync",
                                             fault=True, kept=0.5),
                           tmp, "half")
    try:
        jm, jp, js = D.jax_dp_step(jcfg, params, stats, batch)
        one = D.port_one_process(jcfg, init, batch)
    finally:
        ranks, fault = D.wait_ranks(h_sync), D.wait_ranks(h_fault)
        half = D.wait_ranks(h_half)
    return dict(init=init, jax=(jm, from_flax(jp, js)), one=one,
                ranks=ranks, fault=fault, half=half, cfg=port_config(jcfg))


def test_sync_losses_match_jax_and_one_process(case):
    for r in case["ranks"]:
        assert r["bn_semantics"] == "sync"
        D.assert_metrics_close(r["metrics"][0], case["jax"][0])
        D.assert_metrics_close(r["metrics"][0], case["one"][0])


@pytest.mark.parametrize("ref", ["jax", "one"])
def test_sync_updates_match(case, ref):
    got = case["ranks"][0]["states"][0]
    D.assert_within_gates(D.update_rels(got, case[ref][1], case["init"]))


def test_both_ranks_end_bit_equal(case):
    a, b = case["ranks"]
    assert a["metrics"] == b["metrics"]
    assert all(torch.equal(v, b["states"][0][k])
               for k, v in a["states"][0].items())


def test_detached_all_reduce_fails_the_parameter_gate(case):
    # the forward is unchanged, so the losses agree; the cotangent of each
    # rank's sums lacks the other rank's share, so the update does not
    for ref in ("jax", "one"):
        got = case["fault"][0]["states"][0]
        D.assert_metrics_close(case["fault"][0]["metrics"][0], case[ref][0])
        assert not D.within_gates(D.update_rels(got, case[ref][1],
                                                case["init"]))


def test_half_detached_all_reduce_fails_the_parameter_gate(case):
    # the backward keeps half of the other rank's cotangent of the sums
    for ref in ("jax", "one"):
        got = case["half"][0]["states"][0]
        D.assert_metrics_close(case["half"][0]["metrics"][0], case[ref][0])
        assert not D.within_gates(D.update_rels(got, case[ref][1],
                                                case["init"]))


def test_collectives_a_step(case):
    # each BatchNorm's sums forward and their cotangent backward, the two
    # loss normalizers of the level, one flat buffer of the gradients and
    # metrics, one of the running statistics
    model = RangeDet(**case["cfg"].model_kwargs())
    n_bn = sum(isinstance(m, layers.BatchNormFold) for m in model.modules())
    for r in case["ranks"]:
        assert r["collectives"] == [2 * n_bn + 2 + 2]


MODS = dict(conv3x3=conv3x3, iou=iou_target, meta=meta_block,
            taps=meta_kernel, RangeDet=RangeDet, layers=layers,
            pdist=pdist, create_train_state=create_train_state,
            make_train_step=train_step.make_train_step)


@pytest.mark.parametrize("fused,remat", [(False, False), (True, False),
                                         (True, True)])
def test_group_of_one_is_the_plain_step_bit_for_bit(fused, remat):
    cfg = port_config(D.small_cfg(use_pallas_meta=fused)).replace(
        remat=remat)
    params, stats, batch = D.weights_and_batch(D.small_cfg(fused))
    tb = train_step.batch_to_device(batch, torch.device("cpu"))
    same, _, _, plain, dp = chip_smoke.world1_check(
        torch, MODS, cfg, torch.device("cpu"), from_flax(params, stats), tb,
        "gloo")
    assert same
    n_bn = sum(isinstance(m, layers.BatchNormFold)
               for m in RangeDet(**cfg.model_kwargs()).modules())
    assert plain["collectives"] == [0, 0]
    assert dp["collectives"][0] >= 2 * n_bn + 2 + 2


def test_step_selector_checks_the_batchnorm_group():
    cfg = port_config(D.small_cfg(use_pallas_meta=False))
    model = RangeDet(**cfg.model_kwargs())
    state = create_train_state(model, cfg, 10, seed=0)
    one = train_step.build_train_step_fn(state, cfg)
    assert one.bn_semantics == "sync"
    group = object()
    with mock.patch("torch.distributed.get_world_size", return_value=2):
        with pytest.raises(ValueError, match="set_sync_group"):
            train_step.build_train_step_fn(state, cfg, group)
        layers.set_sync_group(model, group)
        with pytest.raises(ValueError, match="sync_bn=False"):
            train_step.build_train_step_fn(
                state, cfg.replace(sync_bn=False), group)
        assert train_step.build_train_step_fn(
            state, cfg, group).bn_semantics == "sync"
