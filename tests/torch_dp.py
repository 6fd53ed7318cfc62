"""Shared set-up of the data-parallel parity tests: a small config of the
tiny recipe (5x64 frames, one FPN level, no head tower convs, f32, as
tests/test_torch_train.py's fused step), one weight tree and one B=2 numpy
batch; JAX's shard_map step on a {"data": 2} mesh of the conftest's
virtual CPU devices; the port's step over two gloo ranks, each a spawned
process that imports only torch and the port (``chip_smoke.rank_main``);
and the port's one-process B=2 step."""
import copy
import os
import subprocess
import sys

import jax
import numpy as np
import torch

import chip_smoke
from rangedet_tpu.models import RangeDet as JaxRangeDet
from rangedet_tpu.parallel import make_mesh, replicate_state, shard_batch
from rangedet_tpu.train.schedule import build_optimizer as jax_optimizer
from rangedet_tpu.train.state import TrainState
from rangedet_tpu.train.train_step import build_train_step_fn as jax_step_fn
from rangedet_tpu_torch.convert import to_flax
from rangedet_tpu_torch.data.synthetic import make_batch
from rangedet_tpu_torch.models import RangeDet
from rangedet_tpu_torch.train.state import create_train_state
from rangedet_tpu_torch.train.train_step import batch_to_device, make_train_step
from test_torch_train import (
    LOSS_TOL,
    STEPS_PER_EPOCH,
    UPDATE_MEDIAN_TOL,
    UPDATE_TOL,
    _cfg,
)
from torch_parity import TINY_PORT_CONFIG, perturb, port_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SMALL = dict(feat_size=(5, 64), pad_field=(5, 64), fpn_strides=(1,),
             fpn_intervals={1: (0.0, 200.0)}, cls_conv_layers=0,
             reg_conv_layers=0)


def small_cfg(use_pallas_meta: bool, sync_bn: bool = True):
    return _cfg().replace(use_pallas_meta=use_pallas_meta, sync_bn=sync_bn,
                          **SMALL)


def weights_and_batch(jcfg):
    """(params, batch_stats) numpy trees of the port's seeded init,
    perturbed as tests/test_torch_train.py does, and a B=2 batch."""
    model = RangeDet(**port_config(jcfg).model_kwargs())
    model.init_from(torch.Generator().manual_seed(0))
    params, stats = to_flax(model.state_dict())
    params, stats = perturb({"params": params, "batch_stats": stats}, seed=3)
    return params, stats, make_batch(jcfg, 2, seed=0, num_boxes=4)


def jax_dp_step(jcfg, params, stats, batch):
    """One step of JAX's data-parallel train step on {"data": 2}: the
    shard_map step, the model built with bn_sync_axis="data" when
    cfg.sync_bn, else localbn. -> (metrics as floats, params, batch_stats
    as numpy trees)."""
    cfg = jcfg.replace(bn_sync_axis="data" if jcfg.sync_bn else None)
    model = JaxRangeDet(**cfg.model_kwargs())
    tx, _ = jax_optimizer(cfg, STEPS_PER_EPOCH)
    mesh = make_mesh({"data": 2})
    state = replicate_state(TrainState.create(
        apply_fn=model.apply, params=params, batch_stats=stats, tx=tx), mesh)
    flag = "jax_disable_most_optimizations"
    before = jax.config.read(flag)
    jax.config.update(flag, True)
    try:
        state, m = jax.jit(jax_step_fn(model, cfg, mesh))(
            state, shard_batch(batch, mesh))
    finally:
        jax.config.update(flag, before)
    return ({k: float(v) for k, v in m.items()},
            jax.tree_util.tree_map(np.asarray, state.params),
            jax.tree_util.tree_map(np.asarray, state.batch_stats))


def port_one_process(jcfg, state_dict, batch):
    """The port's plain step at B=2 in this process. -> (metrics as
    floats, state dict)."""
    pcfg = port_config(jcfg)
    model = RangeDet(**pcfg.model_kwargs())
    model.load_state_dict(copy.deepcopy(state_dict))
    state = create_train_state(model, pcfg, STEPS_PER_EPOCH, seed=None)
    m = make_train_step(state, pcfg)(batch_to_device(batch,
                                                     torch.device("cpu")))
    return {k: float(v) for k, v in m.items()}, model.state_dict()


def port_ranks_spec(jcfg, state_dict, batch, mode, **kw):
    return dict(cfg=port_config(jcfg), state=state_dict, batch=batch,
                steps=1, device="cpu", backend="gloo", mode=mode, **kw)


def update_rels(got, want, init):
    """Per floating tensor of the state dicts: the update (new - init) of
    ``got`` against ``want``'s, max|a - b| / max|b|."""
    rels = {}
    for k, v0 in init.items():
        if not v0.is_floating_point():
            continue
        d_want = want[k].double() - v0.double()
        d_got = got[k].double() - v0.double()
        assert d_want.abs().max() > 0, k  # every tensor moved
        rels[k] = float((d_got - d_want).abs().max() / d_want.abs().max())
    return rels


def within_gates(rels):
    worst = max(rels, key=rels.get)
    return (rels[worst] <= UPDATE_TOL
            and float(np.median(list(rels.values()))) <= UPDATE_MEDIAN_TOL)


def assert_metrics_close(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **LOSS_TOL)


def assert_within_gates(rels):
    worst = max(rels, key=rels.get)
    assert rels[worst] <= UPDATE_TOL, (worst, rels[worst])
    assert np.median(list(rels.values())) <= UPDATE_MEDIAN_TOL


def start_ranks(spec, tmp, name, world=2):
    return chip_smoke.start_ranks(spec, world, str(tmp), name)


wait_ranks = chip_smoke.wait_ranks


def tiny_recipe(tmp):
    """The tiny recipe as a file under ``tmp``."""
    path = tmp / "tiny_recipe.py"
    path.write_text(TINY_PORT_CONFIG)
    return path


def cli_ranks(tmp, name, cli, argv, world=2):
    """Run ``cli``'s main over ``world`` ranks, as a launcher starts them
    (each ``chip_smoke.cli_rank_main``). -> each rank's saved output and
    its console output."""
    port = chip_smoke.free_port()
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(r), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                   PYTHONPATH=REPO)
        procs.append(subprocess.Popen(
            [sys.executable, chip_smoke.__file__, "--cli-rank",
             str(tmp / name), cli] + argv, env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=180)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return [torch.load(tmp / f"{name}{r}.pt", weights_only=False)
            for r in range(world)], outs
