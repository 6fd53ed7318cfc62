"""The port's train options against the JAX package's, on the CPU at the
tiny recipe: every LR mode and the onecycle momentum against
``rangedet_tpu.train.schedule``; SGD, AdamW and AdamWS (with onecycle's
momentum / beta1) under both clip modes against JAX's optax chain, three
updates on one weight tree and one set of gradients; ``remat`` and
``remat_meta`` against the plain step (bit-equal, running statistics moved
once); the metrics of ``utils/metrics.py`` against JAX's."""
import numpy as np
import pytest
import torch
from unittest import mock

import jax
import jax.numpy as jnp
import optax

from rangedet_tpu.train.schedule import build_optimizer as jax_optimizer
from rangedet_tpu.train.schedule import build_schedule as jax_schedule
from rangedet_tpu.train.schedule import (
    onecycle_momentum_schedule as jax_momentum,
)
from rangedet_tpu.utils import metrics as jmetrics
from rangedet_tpu_torch.convert import flax_ndim, from_flax, to_flax
from rangedet_tpu_torch.data.synthetic import make_batch
from rangedet_tpu_torch.models import RangeDet
from rangedet_tpu_torch.ops import conv3x3
from rangedet_tpu_torch.ops import meta_block
from rangedet_tpu_torch.ops import meta_kernel as ops_mk
from rangedet_tpu_torch.train.schedule import (
    build_momentum_schedule,
    build_schedule,
)
from rangedet_tpu_torch.train.state import create_train_state
from rangedet_tpu_torch.train.train_step import (
    apply_update,
    batch_to_device,
    make_train_step,
)
from rangedet_tpu_torch.utils import metrics as tmetrics
from tiny import tiny_config
from torch_parity import port_config

# one intra-op thread per test process: several workers share the cores
torch.set_num_threads(1)

SPE = 5  # steps an epoch of the schedule tests
EPOCHS = 4
# JAX evaluates the schedules in f32, the port in python floats: JAX's
# error is absolute, up to an ulp or two of its terms (the peak LR), which
# is 2e-6 relative where they cancel (measured: the warmup's first count
# 0.0010000020 for 0.001, the cosine and onecycle tails). Hence atol = 2
# f32 ulps of the largest term beside the rtol.
SCHED_RTOL = 1e-6
# three updates through the bridge: each element within rtol of the largest
# element of its leaf's update (as tests/test_torch_train.py compares
# updates: an element that crosses 0 has no relative error of its own),
# plus the rounding of the weight itself, half an f32 ulp an update on each
# side: 3 ulps of the element; AdamWS's rtol as
# tests/test_train_infra.py::test_adamws_standardizes_conv_kernels
UPDATE_RTOL = 1e-5
ADAMWS_RTOL = 1e-4
ROUNDING_ULPS = 3
GRAD_STD = 20.0  # the elementwise clip at 35 clamps ~8%; the norm >> 35


def _atol(*terms):
    return 2 * float(np.spacing(np.float32(max(abs(t) for t in terms))))


# ---------------------------------------------------------------- schedules
@pytest.mark.parametrize("warmup", [0.0, 1.0])
@pytest.mark.parametrize("mode", ["cosine", "step", "poly", "constant",
                                  "onecycle"])
def test_schedule_matches_jax(mode, warmup):
    # lr_steps 2 and 2.2 land on counts 10 and 11, 1 on 5: with the warmup
    # they count from its end (optax.join_schedules)
    jcfg = tiny_config(lr_mode=mode, warmup_epochs=warmup, warmup_lr=1e-3,
                       end_epoch=EPOCHS, lr_steps=(1, 2, 2.2))
    want, got = jax_schedule(jcfg, SPE), build_schedule(port_config(jcfg),
                                                        SPE)
    counts = range(EPOCHS * SPE + 3)
    w = np.array([float(want(c)) for c in counts])
    g = np.array([got(c) for c in counts])
    np.testing.assert_allclose(g, w, rtol=SCHED_RTOL,
                               atol=_atol(jcfg.base_lr, jcfg.warmup_lr))
    if mode == "step":  # the drops land where optax puts them
        drops = [c for c in counts[1:] if g[c] < g[c - 1] * 0.5]
        shift = SPE if warmup else 0
        assert drops == [5 + shift, 10 + shift, 11 + shift]


@pytest.mark.parametrize("pct_start", [0.4, 0.25])
def test_onecycle_momentum_matches_jax(pct_start):
    jcfg = tiny_config(lr_mode="onecycle", end_epoch=EPOCHS,
                       onecycle_pct_start=pct_start)
    want = jax_momentum(EPOCHS * SPE, moms=jcfg.onecycle_moms,
                        pct_start=pct_start)
    got = build_momentum_schedule(port_config(jcfg), SPE)
    counts = range(EPOCHS * SPE + 3)
    np.testing.assert_allclose([got(c) for c in counts],
                               [float(want(c)) for c in counts],
                               rtol=SCHED_RTOL,
                               atol=_atol(*jcfg.onecycle_moms))
    assert build_momentum_schedule(port_config(tiny_config()), SPE) is None


# ---------------------------------------------------------------- optimizers
def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _map(tree, fn):
    return {k: _map(v, fn) if hasattr(v, "items") else fn(v)
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def weights():
    """The tiny recipe's parameter tree (the port's seeded init through
    the bridge), its batch statistics, and three seeded sets of
    gradients of that tree."""
    model = RangeDet(**port_config(tiny_config()).model_kwargs())
    model.init_from(torch.Generator().manual_seed(0))
    params, stats = to_flax(model.state_dict())
    r = np.random.RandomState(0)
    grads = [_map(params, lambda a: (GRAD_STD * r.randn(*a.shape)).astype(
        np.float32)) for _ in range(3)]
    return params, stats, grads


@pytest.mark.parametrize("clip_mode", ["elementwise", "global_norm"])
@pytest.mark.parametrize("optimizer,lr_mode", [
    ("sgd", "cosine"), ("sgd", "onecycle"), ("adamw", "cosine"),
    ("adamw", "onecycle"), ("adamws", "cosine")])
def test_optimizer_matches_jax(weights, optimizer, lr_mode, clip_mode):
    params, stats, grads = weights
    # 4 updates an epoch, one epoch: the schedules move at every update
    jcfg = tiny_config(optimizer=optimizer, lr_mode=lr_mode,
                       clip_mode=clip_mode, base_lr=0.01, warmup_epochs=0,
                       end_epoch=1)
    tx, _ = jax_optimizer(jcfg, 4)

    @jax.jit
    def update(g, opt_state, p):
        updates, opt_state = tx.update(g, opt_state, p)
        return optax.apply_updates(p, updates), opt_state

    jp = _map(params, jnp.asarray)
    opt_state = tx.init(jp)
    for g in grads:
        jp, opt_state = update(g, opt_state, jp)

    pcfg = port_config(jcfg)
    model = RangeDet(**pcfg.model_kwargs())
    model.load_state_dict(from_flax(params, stats), strict=True)
    state = create_train_state(model, pcfg, 4, seed=None)
    named = dict(model.named_parameters())
    for g in grads:
        for name, t in from_flax(g, {}).items():
            named[name].grad = t.clone()  # t may share g's memory
        apply_update(state, pcfg)
    assert state.step == 3

    got = dict(_leaves(to_flax(model.state_dict())[0]))
    want = dict(_leaves(jp))
    assert sorted(got) == sorted(want)
    rtol = ADAMWS_RTOL if optimizer == "adamws" else UPDATE_RTOL
    old = dict(_leaves(params))
    for k in want:
        step = np.abs(want[k] - old[k]).max()
        assert step > 0, k  # every leaf was updated
        over = (np.abs(got[k] - want[k])
                - ROUNDING_ULPS * np.spacing(np.abs(want[k])))
        assert over.max() <= rtol * step, ("/".join(k), over.max() / step)
    if optimizer == "adamws":  # JAX's set: exactly its 4-D leaves
        std = {id(p) for p, _ in state.standardized}
        four_d = {n for n, p in named.items() if id(p) in std}
        assert four_d == {n for n, p in named.items()
                          if flax_ndim(n, p.shape) == 4}
        assert any(n.endswith("sc_weight") for n in named)
        assert not any(n.endswith("sc_weight") for n in four_d)


def test_flax_ndim_is_the_bridge_leaf_rank(weights):
    params, stats, _ = weights
    model = RangeDet(**port_config(tiny_config()).model_kwargs())
    model.load_state_dict(from_flax(params, stats), strict=True)
    for name, p in model.named_parameters():
        leaf = to_flax({name: p.detach()})[0]
        while hasattr(leaf, "items"):
            (leaf,) = leaf.values()
        assert flax_ndim(name, tuple(p.shape)) == leaf.ndim, name


# ---------------------------------------------------------------- remat
def _remat_step(cfg, batch):
    """One port step from the tiny recipe's seeded init -> (metrics, state
    dict after it, calls of the conv forward, meta_stats, meta_agg and the
    materialized taps)."""
    model = RangeDet(**cfg.model_kwargs())
    model.init_from(torch.Generator().manual_seed(0))
    state = create_train_state(model, cfg, 100, seed=None)
    calls = dict.fromkeys(("fwd", "stats", "agg", "taps"), 0)

    def counted(key, real):
        def call(*a, **kw):
            calls[key] += 1
            return real(*a, **kw)
        return call

    with mock.patch.object(conv3x3, "conv3x3_bhcw",
                           counted("fwd", conv3x3.conv3x3_bhcw)), \
            mock.patch.object(meta_block, "meta_stats",
                              counted("stats", meta_block.meta_stats)), \
            mock.patch.object(meta_block, "meta_agg",
                              counted("agg", meta_block.meta_agg)), \
            mock.patch.object(ops_mk, "meta_kernel_taps_plain",
                              counted("taps",
                                      ops_mk.meta_kernel_taps_plain)):
        metrics = make_train_step(state, cfg)(batch)
    return metrics, model.state_dict(), calls


@pytest.mark.parametrize("fused,remat,remat_meta", [
    (True, True, False), (True, True, True), (False, False, True),
    (False, True, True)])
def test_remat_step_is_bit_equal_to_the_plain_step(fused, remat, remat_meta):
    cfg = port_config(tiny_config(dtype=jnp.float32)).replace(
        use_pallas_meta=fused, base_lr=0.01, warmup_epochs=0)
    batch = batch_to_device(make_batch(cfg, 2, seed=0, num_boxes=4),
                            torch.device("cpu"))
    m0, sd0, c0 = _remat_step(cfg, batch)
    m1, sd1, c1 = _remat_step(cfg.replace(remat=remat,
                                          remat_meta=remat_meta), batch)
    assert sorted(m0) == sorted(m1)
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    assert sorted(sd0) == sorted(sd1)
    # parameters and running statistics: the latter moved once
    assert all(torch.equal(sd0[k], sd1[k]) for k in sd0), [
        k for k in sd0 if not torch.equal(sd0[k], sd1[k])]
    # the recompute ran: every stage conv again under remat (29 convs,
    # 19 of them in stages), the block again if it is checkpointed
    n_stage = c0["fwd"] - 4 - 3 * 2  # 4 deconvs, 3 levels x 2 head convs
    assert c1["fwd"] == c0["fwd"] + (n_stage if remat else 0)
    if fused:  # the fused block is never wrapped alone; remat reruns it
        assert (c0["stats"], c0["agg"]) == (1, 1)
        assert (c1["stats"], c1["agg"]) == ((2, 2) if remat else (1, 1))
    else:  # nested: the stage's recompute runs the block's forward too
        assert c0["taps"] == 1 and c1["taps"] == 1 + remat + remat_meta


def test_remat_model_evaluates_as_the_plain_one():
    cfg = port_config(tiny_config(dtype=jnp.float32))
    batch = make_batch(cfg, 1, seed=1, num_boxes=4)
    outs = []
    for remat in (False, True):
        model = RangeDet(**cfg.replace(remat=remat,
                                       remat_meta=remat).model_kwargs())
        model.init_from(torch.Generator().manual_seed(0))
        with torch.no_grad():
            outs.append(model.eval()(torch.as_tensor(batch["input_data"]),
                                     torch.as_tensor(batch["coord"])))
    for a, b in zip(*(o[0] + o[1] for o in outs)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------- metrics
def _metric_inputs(seed=0):
    r = np.random.RandomState(seed)
    shape = (2, 4, 16)
    return dict(score=r.uniform(0, 1, shape).astype(np.float32),
                target=(r.uniform(0, 1, shape) > 0.6).astype(np.float32),
                mask=(r.uniform(0, 1, shape) > 0.3).astype(np.float32),
                pred=r.randn(*shape).astype(np.float32),
                reg=r.randn(*shape).astype(np.float32),
                weight=(r.uniform(0, 1, shape) > 0.5).astype(np.float32),
                loss=np.float32(r.uniform(0, 3)))


def _metrics(mod):
    return [mod.ScalarLoss("loss", "loss"),
            mod.ScalarLoss("absent", "no_such_key"),
            mod.AccWithIgnore("acc", "score", "target", "mask"),
            mod.CeWithIgnore("ce", "score", "target", "mask"),
            mod.L1Metric("l1", "pred", "reg", "weight")]


def test_metrics_match_jax():
    got = tmetrics.CompositeMetric(_metrics(tmetrics))
    want = jmetrics.CompositeMetric(_metrics(jmetrics))
    for rnd in range(2):
        for seed in range(3):
            outputs = _metric_inputs(seed)
            got.update(**outputs)
            want.update(**outputs)
        assert got.get() == want.get()
        assert got.format() == want.format()
        for a, b in zip(got.metrics, want.metrics):
            assert a.get() == b.get()
        got.reset()
        want.reset()
        assert got.get() == want.get()
