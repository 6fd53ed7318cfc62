"""The port's data-parallel train step with per-rank BatchNorm
(sync_bn=False, the reference's "localbn") on the CPU: two gloo ranks, each
B=1 of one B=2 batch, against JAX's local-BN shard_map step on {"data": 2}
(each shard's statistics and loss normalizers, gradients and metrics
averaged, the running statistics averaged every step):
tests/test_torch_train.py's tolerances, both ranks bit-equal."""
import pytest
import torch

import torch_dp as D
from rangedet_tpu_torch.convert import from_flax

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    jcfg = D.small_cfg(use_pallas_meta=False, sync_bn=False)
    params, stats, batch = D.weights_and_batch(jcfg)
    init = from_flax(params, stats)
    handle = D.start_ranks(D.port_ranks_spec(jcfg, init, batch, "local"),
                           tmp_path_factory.mktemp("dp_local"), "local")
    try:
        jm, jp, js = D.jax_dp_step(jcfg, params, stats, batch)
    finally:
        ranks = D.wait_ranks(handle)
    return dict(init=init, jax=(jm, from_flax(jp, js)), ranks=ranks)


def test_local_losses_match_jax(case):
    for r in case["ranks"]:
        assert r["bn_semantics"] == "local"
        D.assert_metrics_close(r["metrics"][0], case["jax"][0])


def test_local_update_and_averaged_running_statistics_match_jax(case):
    got = case["ranks"][0]["states"][0]
    rels = D.update_rels(got, case["jax"][1], case["init"])
    D.assert_within_gates(rels)
    D.assert_within_gates({k: v for k, v in rels.items() if "running" in k})


def test_local_ranks_end_bit_equal(case):
    a, b = case["ranks"]
    assert a["metrics"] == b["metrics"]
    assert all(torch.equal(v, b["states"][0][k])
               for k, v in a["states"][0].items())
