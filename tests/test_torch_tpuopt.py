"""The wide-channel recipe rangedet_veh_tpuopt_all_36e of the port against
the JAX package, on the CPU: the plain versions of the Meta-Kernel kernels
3-5 (ops/meta_block.py) and 7 (ops/meta_kernel.py) at the recipe's
Meta-Kernel widths (C = 128, Cm = 32, Co = 128) against the Pallas kernels
in interpret mode, under tests/test_torch_meta_block.py's and
tests/test_torch_meta_kernel.py's tolerances; the weight bridge at the
recipe's channel widths and depth; and one fused train step
and the eval step on a tiny field at its channel widths, under
tests/test_torch_train.py's and tests/torch_parity.py's tolerances. On the
CPU every wrapper takes its plain version; chip_smoke.py phase [9] holds
the kernels' C = 128 instance to them on the card."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_meta_block as TB
import test_torch_meta_kernel as TK
import test_torch_train as TT
from rangedet_tpu.configs import load_config as jax_load_config
from rangedet_tpu.data.synthetic import make_batch
from rangedet_tpu.ops import meta_block_pallas as jmb
from rangedet_tpu.ops.meta_kernel_pallas import meta_kernel_fused
from rangedet_tpu_torch.configs import load_config
from rangedet_tpu_torch.convert import from_flax, to_flax
from rangedet_tpu_torch.models import RangeDet
from rangedet_tpu_torch.ops import meta_block as mb
from rangedet_tpu_torch.ops import meta_kernel as mk
from tiny import tiny_config
from torch_parity import check_eval_step, port_config

# one intra-op thread per test process: several workers share the cores
torch.set_num_threads(1)

RECIPE = "rangedet_veh_tpuopt_all_36e"
C, CM, CO = 128, 32, 128  # the recipe's Meta-Kernel block
# a few steps of the parity tests at the recipe's widths
WIDE = dict(num_filter=dict(load_config(RECIPE).num_filter),
            meta_units={"res1_unit2": dict(channel_list=(CM, C))})
CASES = [("f32", (1, 2, 20)), ("bf16", (1, 2, 19))]


def test_recipe_widths():
    cfg = load_config(RECIPE, is_train=True)
    assert cfg.meta_units["res1_unit2"]["channel_list"] == (CM, C)
    assert cfg.num_filter["res1"] == CO  # the block's output: res1's width
    assert max(cfg.num_filter.values()) == 256
    assert cfg.use_pallas_meta and cfg.batch_image == 2
    assert (C, CM, CO) in mb.BUILT_WIDTHS


def _inputs(seed, B, H, W):
    r = np.random.default_rng(seed)

    def n(*shape, scale=1.0):
        return (scale * r.standard_normal(shape)).astype(np.float32)

    return dict(
        feat=n(B, H, C, W), cb=n(B, H, 3, W, scale=2.0),
        w0=n(3, CM, scale=3 ** -0.5), b0=n(CM, scale=0.1),
        w1=n(CM, C, scale=CM ** -0.5), b1=n(C, scale=0.1),
        s9=1.0 + n(9 * C, scale=0.3), b9=n(9 * C, scale=0.2),
        agg=n(9 * C, CO, scale=(9 * C) ** -0.5), gy=n(B, H, CO, W),
        c1=n(9 * C, scale=0.1), c2=n(9 * C, scale=0.05),
    )


@pytest.mark.parametrize("kind", ["stats", "agg", "bwd_agg", "bwd_stats"])
@pytest.mark.parametrize("dt,shape", CASES)
def test_plain_block_kernels_match_pallas_at_c128(kind, dt, shape):
    jx, tx = TB._sides(_inputs(0, *shape), dt)
    f32 = dt == "f32"
    if kind == "stats":
        want = jmb.meta_stats_pallas(jx["feat"], jx["cb"], *TB._mlp(jx),
                                     interpret=True)
        got = mb.meta_stats_plain(tx["feat"], tx["cb"], *TB._mlp(tx))
        tols = [TB.F32_TOL if f32 else TB.BF16_TOL] * 2
    elif kind == "agg":
        want = [jmb.meta_agg_pallas(jx["feat"], jx["cb"], *TB._mlp(jx),
                                    jx["s9"], jx["b9"], jx["agg"],
                                    interpret=True)]
        got = [mb.meta_agg_plain(tx["feat"], tx["cb"], *TB._mlp(tx),
                                 tx["s9"], tx["b9"], tx["agg"])]
        tols = [TB.F32_TOL if f32 else TB.BF16_TOL]
    else:
        mode = kind[4:]
        keys = ("s9", "b9", "agg", "gy") if mode == "agg" else ("c1", "c2")
        out = jmb._bwd_call(jx["feat"], jx["cb"], *TB._mlp(jx),
                            tuple(jx[k] for k in keys), mode, True)
        mlp = jmb._unpack_mlp(*out[-4:])
        want = ((out[0], out[1], out[2][:, 0], out[3][:, 0], *mlp)
                if mode == "agg" else (out[0], *mlp))
        got = mb.meta_bwd_plain(tx["feat"], tx["cb"], *TB._mlp(tx),
                                tuple(tx[k] for k in keys), mode)
        tols = [TB.F32_TOL if f32 else TB.BF16_DFEAT_TOL] + [
            TB.F32_TOL if f32 else TB.BF16_TOL] * (len(want) - 1)
    assert len(got) == len(want)
    for i, (g, w, tol) in enumerate(zip(got, want, tols)):
        assert tuple(g.shape) == w.shape, i
        assert TB._rel(g, w) <= tol, (i, TB._rel(g, w))


@pytest.mark.parametrize("dt,shape", [("f32", (1, 4, 21)),
                                      ("bf16", (1, 3, 26))])
def test_plain_taps_match_pallas_at_c128(dt, shape):
    jd, td = TK.DT[dt]
    r = np.random.default_rng(1)
    B, H, W = shape
    x = dict(feat=r.standard_normal((B, H, W, C)).astype(np.float32),
             coords=r.standard_normal((B, H, W, 3)).astype(np.float32),
             w0=(3 ** -0.5 * r.standard_normal((3, CM))).astype(np.float32),
             b0=(0.1 * r.standard_normal(CM)).astype(np.float32),
             w1=(CM ** -0.5 * r.standard_normal((CM, C))).astype(np.float32),
             b1=(0.1 * r.standard_normal(C)).astype(np.float32))
    want = TK._bhcw(meta_kernel_fused(*TK._jax(x, jd), CM, True))
    got = mk.meta_kernel_taps(*TK._port(x, td))
    assert got.dtype == td and tuple(got.shape) == (B, H, 9 * C, W)
    tol = TK.F32_TOL if dt == "f32" else TK.BF16_TOL
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol)


def test_bridge_at_the_recipe_widths():
    # the recipe's num_block, num_filter, Meta-Kernel (32, 128) and 4x128
    # head towers: the JAX model's parameter tree (its shapes, filled from a
    # seed) goes through from_flax into exactly the port model's tensors
    # and back through to_flax unchanged. (The forward at these channel
    # widths is held to JAX's by the train and eval step tests below.)
    from rangedet_tpu.models import RangeDet as JaxRangeDet

    cfg = jax_load_config(RECIPE, False).replace(
        feat_size=(8, 64), pad_field=(8, 64), dtype=jnp.float32)
    batch = make_batch(cfg, 1, seed=5, num_boxes=4)
    jmodel = JaxRangeDet(**cfg.model_kwargs())
    shapes = jax.eval_shape(
        lambda k, x, c: jmodel.init(k, x, c, False), jax.random.PRNGKey(0),
        jnp.asarray(batch["input_data"]), jnp.asarray(batch["coord"]))
    r = np.random.default_rng(6)
    params, stats = (jax.tree_util.tree_map(
        lambda a: r.standard_normal(a.shape).astype(np.float32),
        shapes[k]) for k in ("params", "batch_stats"))
    sd = from_flax(params, stats)
    own = RangeDet(**port_config(cfg).model_kwargs()).state_dict()
    assert set(sd) == set(own)
    for k in own:
        assert sd[k].shape == own[k].shape, k
    meta = "backbone.res1.res1_unit2.meta_block."
    assert sd[meta + "meta_agg.weight"].shape == (CO, 9 * C, 1, 1)
    assert sd[meta + "meta_kernel.mlp1.weight"].shape == (C, CM)
    assert sd["backbone.res3a.res3a_unit1.conv1.weight"].shape[:2] == (
        256, 256)
    p2, s2 = to_flax(sd)
    for a, b in ((params, p2), (stats, s2)):
        fa, fb = dict(TT._leaves(a)), dict(TT._leaves(b))
        assert set(fa) == set(fb)
        for k in fa:
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=str(k))


@pytest.fixture(scope="module")
def fused_step():
    # tests/test_torch_train.py's fused-block step at the recipe's channel
    # widths: 5x64 frames, one FPN level, no head tower convs
    cfg = tiny_config(RECIPE, layout="bhcw", dtype=jnp.float32,
                      use_pallas_meta=True, use_pallas_iou=False,
                      iou_topk_gt=0, feat_size=(5, 64), pad_field=(5, 64),
                      fpn_strides=(1,), fpn_intervals={1: (0.0, 200.0)},
                      cls_conv_layers=0, reg_conv_layers=0, **WIDE).replace(
        base_lr=0.01, warmup_epochs=0)
    flag = "jax_disable_most_optimizations"
    before = jax.config.read(flag)
    jax.config.update(flag, True)
    try:
        return TT._one_step(cfg, port_init=True)
    finally:
        jax.config.update(flag, before)


def test_fused_train_step_metrics_match_jax(fused_step):
    TT._assert_metrics_match(fused_step)


def test_fused_train_step_updates_match_jax(fused_step):
    TT._assert_updates_match(fused_step)


def test_eval_step_matches_jax():
    check_eval_step("bhcw", use_pallas_meta=True, recipe=RECIPE, **WIDE)


def test_a_width_with_no_kernel_raises():
    # the kernels' instances are (C, Cm, Co) = (64, 32, 64), (128, 32, 128):
    # any other width raises before the library is loaded, with no
    # fallback to the plain version
    for c, cm, co in ((96, 32, 96), (128, 16, 128), (128, 32, 64)):
        x = dict(feat=torch.zeros(1, 2, c, 8, dtype=torch.bfloat16),
                 cb=torch.zeros(1, 2, 3, 8), w0=torch.zeros(3, cm),
                 b0=torch.zeros(cm), w1=torch.zeros(cm, c), b1=torch.zeros(c))
        with pytest.raises(ValueError, match="no kernel is built"):
            mb._kernel_inputs(*x.values(), co)
    with pytest.raises(ValueError, match="no kernel is built"):
        mb._kernel_inputs(torch.zeros(1, 2, 32, 8, dtype=torch.bfloat16),
                          torch.zeros(1, 2, 3, 8), torch.zeros(3, 32),
                          torch.zeros(32), torch.zeros(32, 32),
                          torch.zeros(32))


# ---------------------------------------------------------------- card
@pytest.mark.cuda
def test_c128_kernels_match_plain_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    # W = 70 is ragged (rows copied to a pitch of 72)
    for B, H, W in ((2, 8, 96), (1, 3, 70)):
        TB._check_meta_kernels(dev, g, B, H, W, C, CO)
        TK._check_taps_kernel(dev, g, B, H, W, C)
