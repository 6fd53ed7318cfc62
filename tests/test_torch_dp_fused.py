"""The port's data-parallel train step in sync mode with the recipe's fused
Meta-Kernel block (use_pallas_meta=True: meta_stats' sums summed over the
ranks into meta_bn's fold) on the CPU: two gloo ranks, each B=1 of one B=2
batch, against JAX's shard_map step on {"data": 2} (its Pallas block in
interpret mode) and against the port's one-process B=2 step, both ranks
bit-equal (tests/test_torch_train.py's tolerances); with remat (every
backbone stage under torch.utils.checkpoint, its recompute summing its
BatchNorm statistics over the ranks again) the two ranks end bit-equal to
the run without it."""
import pytest
import torch

import torch_dp as D
from rangedet_tpu_torch.convert import from_flax

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    jcfg = D.small_cfg(use_pallas_meta=True)
    params, stats, batch = D.weights_and_batch(jcfg)
    init = from_flax(params, stats)
    tmp = tmp_path_factory.mktemp("dp_fused")
    handle = D.start_ranks(D.port_ranks_spec(jcfg, init, batch, "sync"),
                           tmp, "fused")
    h_remat = D.start_ranks(D.port_ranks_spec(jcfg.replace(remat=True),
                                              init, batch, "sync"),
                            tmp, "remat")
    try:
        jm, jp, js = D.jax_dp_step(jcfg, params, stats, batch)
        one = D.port_one_process(jcfg, init, batch)
    finally:
        ranks, remat = D.wait_ranks(handle), D.wait_ranks(h_remat)
    return dict(init=init, jax=(jm, from_flax(jp, js)), one=one,
                ranks=ranks, remat=remat)


@pytest.mark.parametrize("ref", ["jax", "one"])
def test_fused_sync_losses_match(case, ref):
    for r in case["ranks"]:
        assert r["bn_semantics"] == "sync"
        D.assert_metrics_close(r["metrics"][0], case[ref][0])


@pytest.mark.parametrize("ref", ["jax", "one"])
def test_fused_sync_updates_match(case, ref):
    got = case["ranks"][0]["states"][0]
    D.assert_within_gates(D.update_rels(got, case[ref][1], case["init"]))


def test_fused_ranks_end_bit_equal(case):
    a, b = case["ranks"]
    assert a["metrics"] == b["metrics"]
    assert all(torch.equal(v, b["states"][0][k])
               for k, v in a["states"][0].items())


def test_fused_remat_ranks_equal_the_run_without_remat(case):
    for r, plain in zip(case["remat"], case["ranks"]):
        assert r["metrics"] == plain["metrics"]
        assert all(torch.equal(v, plain["states"][0][k])
                   for k, v in r["states"][0].items())
        # the recompute sums the stages' BatchNorm statistics once more
        assert r["collectives"][0] > plain["collectives"][0]
    D.assert_within_gates(D.update_rels(case["remat"][0]["states"][0],
                                        case["jax"][1], case["init"]))
