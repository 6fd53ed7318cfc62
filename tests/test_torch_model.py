"""The port's config mirror, weight bridge and forward pass against the JAX
package: the same weights and the same numpy batch through both, in f32."""
import dataclasses
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rangedet_tpu.configs
import rangedet_tpu_torch.configs
from rangedet_tpu.configs import load_config as jax_load_config
from rangedet_tpu.configs.base import RangeDetConfig as JaxConfig
from rangedet_tpu.data.synthetic import make_batch
from rangedet_tpu_torch.configs import load_config
from rangedet_tpu_torch.configs.base import RangeDetConfig as TorchConfig
from rangedet_tpu_torch.convert import from_flax, load_npz, save_npz, to_flax
from rangedet_tpu_torch.models import RangeDet
from tiny import tiny_config
from torch_parity import (
    DTYPES,
    SKIPPED_FIELDS,
    init_jax,
    perturb,
    port_config,
    port_model,
)

# one intra-op thread per test process: several workers share the cores
torch.set_num_threads(1)

# f32 forward tolerance: the same math in another summation order
FWD_TOL = dict(atol=2e-4, rtol=1e-3)


# every recipe the port ships: all of rangedet_tpu/configs/
PORT_RECIPES = sorted(
    p.stem for p in (pathlib.Path(rangedet_tpu_torch.configs.__file__).parent
                     ).glob("rangedet_*.py"))


def test_port_ships_every_recipe():
    jax_recipes = sorted(
        p.stem for p in (pathlib.Path(rangedet_tpu.configs.__file__).parent
                         ).glob("rangedet_*.py"))
    assert PORT_RECIPES == jax_recipes
    assert len(PORT_RECIPES) == 7


@pytest.mark.parametrize("recipe", PORT_RECIPES)
@pytest.mark.parametrize("is_train", [True, False])
def test_config_mirror_matches_jax_field_by_field(is_train, recipe):
    jfields = {f.name for f in dataclasses.fields(JaxConfig)}
    tfields = {f.name for f in dataclasses.fields(TorchConfig)}
    assert tfields == jfields - SKIPPED_FIELDS, (
        tfields ^ (jfields - SKIPPED_FIELDS))
    assert SKIPPED_FIELDS <= jfields
    jc = jax_load_config(recipe, is_train)
    tc = load_config(recipe, is_train)
    assert tc.use_pallas_meta
    for name in sorted(tfields):
        want = getattr(jc, name)
        got = getattr(tc, name)
        if name == "dtype":
            assert got == DTYPES[want]
        else:
            assert got == want, name
    assert tc.num_classes == jc.num_classes
    jk = jc.model_kwargs()
    for k, v in tc.model_kwargs().items():
        assert (v == DTYPES[jk[k]]) if k == "dtype" else (v == jk[k]), k


def _tiny(**kw):
    return tiny_config(is_train=False, layout="bhcw", dtype=jnp.float32, **kw)


@pytest.fixture(scope="module")
def tiny_init():
    cfg = _tiny()
    batch = make_batch(cfg, 2, seed=3, num_boxes=4)
    jmodel, v = init_jax(cfg, batch)
    return cfg, batch, jmodel, v


def test_bridge_round_trip(tmp_path, tiny_init):
    cfg, _, _, v = tiny_init
    params, stats = perturb(v, seed=1)
    sd = from_flax(params, stats)
    # every port tensor is covered and shaped like the port's own
    model = RangeDet(**port_config(cfg).model_kwargs())
    own = model.state_dict()
    assert set(sd) == set(own)
    for k in own:
        assert sd[k].shape == own[k].shape, k
    p2, s2 = to_flax(sd)
    for a, b in ((params, p2), (stats, s2)):
        fa = dict(_leaves(a))
        fb = dict(_leaves(b))
        assert set(fa) == set(fb)
        for k in fa:
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=str(k))
    f = tmp_path / "w.npz"
    save_npz(str(f), params, stats)
    back = load_npz(str(f))
    for k in sd:
        torch.testing.assert_close(back[k], sd[k], rtol=0, atol=0)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _forward_both(cfg, batch, jmodel, v, seed):
    params, stats = perturb(v, seed=seed)
    jl, jd = jmodel.apply(
        {"params": params, "batch_stats": stats},
        jnp.asarray(batch["input_data"]), jnp.asarray(batch["coord"]), False,
    )
    model = port_model(port_config(cfg), params, stats)
    with torch.inference_mode():
        tl, td = model(torch.from_numpy(batch["input_data"]),
                       torch.from_numpy(batch["coord"]))
    return jl + jd, tl + td


def test_tiny_forward_matches_jax(tiny_init):
    cfg, batch, jmodel, v = tiny_init
    want, got = _forward_both(cfg, batch, jmodel, v, seed=2)
    assert len(want) == len(got) == 6
    for w, g in zip(want, got):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **FWD_TOL)


def test_recipe_width_forward_matches_jax():
    # full num_filter / num_block / meta (32, 64) / 4x128 head towers on an
    # 8x256 range image: the bridge at the recipe's real parameter shapes
    cfg = jax_load_config("rangedet_veh_wo_aug_4_18e", False).replace(
        feat_size=(8, 256), pad_field=(8, 256), dtype=jnp.float32,
        use_pallas_meta=False,
    )
    assert cfg.num_filter is None and cfg.meta_units is None
    batch = make_batch(cfg, 1, seed=5, num_boxes=4)
    want, got = _forward_both(cfg, batch, *init_jax(cfg, batch), seed=4)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **FWD_TOL)
