"""The port's width ops (``parallel/halo.py``, ``models/layers.py:
conv3x3_width`` / ``deconv_width``, the Meta-Kernel's width path) on the
CPU in f32:

* over two gloo ranks (one spawn for the module: ``chip_smoke.rank_main``
  in its "ops" mode), each holding half of the columns, against JAX's
  ``width_halo_exchange`` + op inside ``shard_map`` on the conftest's
  {"model": 2} mesh: the 3x3 conv at stride 1 and 2, the deconvs at s=2
  and s=4, the Meta-Kernel; outputs and the VJPs of sum(y * r) within
  1e-5 of max|ref| (the weights' gradients summed over the ranks);
* with a width group of one, in this process: bit-equal to the unsharded
  ops, outputs and gradients (the Meta-Kernel's MLP gradients, sums over
  two more zero columns, within 1e-6 of max|ref|);
* the mesh as pure functions: r -> (d, m) on data=2,model=2, the width
  groups' members, a rank's rows and columns, the meshes refused."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P

import chip_smoke
import torch_dp as D
from rangedet_tpu.models.layers import (
    conv3x3_bhcw_width_sharded,
    deconv_bhcw_best,
    width_halo_exchange,
)
from rangedet_tpu.models.meta_kernel import MetaKernel as JaxMetaKernel
from rangedet_tpu.parallel import make_mesh
from rangedet_tpu_torch.models.dla_backbone import DECONV_HALO, WIDTH_STRIDE
from rangedet_tpu_torch.parallel import dist as pdist

torch.set_num_threads(1)

TOL = 1e-5  # of max|ref|, outputs and VJPs
MLP = ("w0", "b0", "w1", "b1")  # the Meta-Kernel's weights
H, W = 5, 64
CASES = {  # name: a case of chip_smoke.op_inputs, (kind, Ci, Co or Cm, H,
    # W, stride)
    "conv_s1": ("conv", 8, 16, H, W, 1),
    "conv_s2": ("conv", 8, 16, H, W, 2),
    "deconv_s2": ("deconv", 16, 8, H, W // 4, 2),
    "deconv_s4": ("deconv", 16, 8, H, W // 4, 4),
    "meta": ("meta", 16, 8, H, W, 1),
}
NAMES = sorted(CASES)
SEED = 7


def case_inputs(name):
    """The f32 inputs of a case, in the port's layouts (host tensors)."""
    return chip_smoke.op_inputs(torch, CASES[name], SEED + NAMES.index(name),
                                torch.float32)


def vjp_jit(f, args, r):
    """f(*args) and the VJP of sum(f * r), in one jit. -> numpy arrays."""
    def both(args, r):
        y, vjp = jax.vjp(f, *args)
        return y, vjp(r)

    y, g = jax.jit(both)(args, jnp.asarray(r))
    return np.asarray(y), [np.asarray(t) for t in g]


def jax_case(name, mesh):
    """JAX's width op in shard_map over "model" on the same inputs: ->
    (y, {gradients of sum(y * r)}) in the port's layouts."""
    kind, _, _, _, _, s = CASES[name]
    cols, whole = case_inputs(name)
    c = {k: v.numpy() for k, v in cols.items()}
    w = {k: v.numpy() for k, v in whole.items()}
    shard = P(None, None, None, "model")
    if kind == "meta":
        C, Cm = c["feat"].shape[2], w["w0"].shape[0]
        mod = JaxMetaKernel(channel_list=(Cm, C), dtype=jnp.float32,
                            layout="bhcw", width_axis="model")

        def per_shard(feat, coords, w0, b0, w1, b1):
            p = {"mlp0": {"kernel": w0, "bias": b0},
                 "mlp1": {"kernel": w1, "bias": b1}}
            return mod.apply({"params": p}, feat, coords)

        f = shard_map(per_shard, mesh=mesh,
                      in_specs=(shard, P(None, None, "model", None), P(), P(),
                                P(), P()),
                      out_specs=shard, check_rep=False)
        coords = jnp.asarray(c["coords"].transpose(0, 1, 3, 2))
        args = [jnp.asarray(c["feat"]), jnp.asarray(w["w0"].T),
                jnp.asarray(w["b0"]), jnp.asarray(w["w1"].T),
                jnp.asarray(w["b1"])]
        y, g = vjp_jit(lambda feat, *p: f(feat, coords, *p), args, c["r"])
        return y, dict(feat=g[0], w0=g[1].T, b0=g[2], w1=g[3].T, b1=g[4])

    if kind == "conv":
        k = w["weight"].transpose(2, 3, 1, 0)  # (3, 3, Ci, Co)

        def per_shard(x, k):
            return conv3x3_bhcw_width_sharded(x, k, s, False, "model")
    else:
        k = w["weight"][:, :, ::-1, ::-1].transpose(2, 3, 0, 1)
        halo = k.shape[1] // s + 2  # J + 2

        def per_shard(x, k):
            xe = width_halo_exchange(x, "model", halo)
            return deconv_bhcw_best(xe, k, s)[..., s * halo:-s * halo]

    f = shard_map(per_shard, mesh=mesh, in_specs=(shard, P()),
                  out_specs=shard, check_rep=False)
    y, (gx, gk) = vjp_jit(f, [jnp.asarray(c["x"]), jnp.asarray(k.copy())],
                          c["r"])
    gw = (gk.transpose(3, 2, 0, 1) if kind == "conv"
          else gk.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1])
    return y, dict(x=gx, weight=gw)


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """The port's ops over two ranks (their columns put together, their
    weights' gradients summed) and JAX's, every case."""
    spec = dict(mode="ops", op_cases=[CASES[n] for n in NAMES],
                op_seed=SEED, op_dtype=torch.float32, op_faults=(),
                device="cpu", backend="gloo", mesh={"data": 1, "model": 2})
    handle = D.start_ranks(spec, tmp_path_factory.mktemp("width_ops"), "ops")
    try:
        mesh = make_mesh({"model": 2})
        want = {name: jax_case(name, mesh) for name in NAMES}
    finally:
        ranks = [r["honest"] for r in D.wait_ranks(handle)]
    got = {}
    for i, name in enumerate(NAMES):
        y = torch.cat([r[i][0] for r in ranks], dim=-1)
        grads = {}
        for k in ranks[0][i][1]:
            parts = [r[i][1][k] for r in ranks]
            grads[k] = (torch.cat(parts, dim=-1) if k in ("x", "feat")
                        else sum(parts))
        got[name] = (y, grads)
    return got, want


def close(got, want):
    want = np.asarray(want, np.float64)
    err = np.abs(got.double().numpy() - want).max()
    return err <= TOL * np.abs(want).max(), err


@pytest.mark.parametrize("name", NAMES)
def test_two_ranks_match_jax_shard_map(sharded, name):
    (y, grads), (want_y, want_g) = sharded[0][name], sharded[1][name]
    assert tuple(y.shape) == want_y.shape
    ok, err = close(y, want_y)
    assert ok, (name, "output", err)
    assert sorted(grads) == sorted(want_g)
    for k in want_g:
        ok, err = close(grads[k], want_g[k])
        assert ok, (name, k, err)


@pytest.fixture(scope="module")
def group_of_one():
    ranks = pdist.join("cpu", backend="gloo", rank=0, world_size=1,
                       init_method=f"tcp://127.0.0.1:{chip_smoke.free_port()}",
                       always=True)
    try:
        yield ranks.group
    finally:
        pdist.leave(ranks)


@pytest.mark.parametrize("name", NAMES)
def test_group_of_one_is_the_unsharded_op_bit_for_bit(group_of_one, name):
    kind, s = CASES[name][0], CASES[name][5]
    cols, whole = case_inputs(name)
    cpu = torch.device("cpu")
    y, grads = chip_smoke.width_op_case(torch, kind, cols, whole, s,
                                        group_of_one, cpu)
    want_y, want_g = chip_smoke.width_op_case(torch, kind, cols, whole, s,
                                              None, cpu)
    assert torch.equal(y, want_y)
    assert sorted(grads) == sorted(want_g)
    for k in want_g:
        if k in MLP:  # sums over W+2 columns, two of them zeros: the CPU's
            # reduction blocks them differently, an f32 rounding apart
            np.testing.assert_allclose(grads[k], want_g[k], rtol=0,
                                       atol=1e-6 * want_g[k].abs().max())
        else:
            assert torch.equal(grads[k], want_g[k]), k


def test_rank_mapping_of_data2_model2():
    assert pdist.check_mesh({"data": 2, "model": 2}, 4) == (2, 2)
    assert [pdist.mesh_place(r, 2) for r in range(4)] == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    assert [pdist.width_members(d, 2) for d in range(2)] == [[0, 1], [2, 3]]
    batch = {"input_data": np.arange(4 * 2 * 8).reshape(4, 2, 8, 1),
             "gt_csa": np.arange(4 * 3 * 7).reshape(4, 3, 7)}
    for r in range(4):
        d, m = pdist.mesh_place(r, 2)
        part = pdist.local_rows(batch, d, 2, m, 2)
        np.testing.assert_array_equal(
            part["input_data"], batch["input_data"][2 * d:2 * d + 2, :,
                                                   4 * m:4 * m + 4])
        # arrays that are not (B, H, W, C) images split by rows only
        np.testing.assert_array_equal(part["gt_csa"],
                                      batch["gt_csa"][2 * d:2 * d + 2])


@pytest.mark.parametrize("mesh,world,message", [
    ({"data": 2, "model": 2}, 2, "world size"),
    ({"model": 2}, 4, "world size"),
    ({"data": 2, "pipe": 2}, 4, "axes"),
    ({"data": 0, "model": 2}, 0, ">= 1"),
])
def test_refused_meshes(mesh, world, message):
    with pytest.raises(ValueError, match=message):
        pdist.check_mesh(mesh, world)


@pytest.mark.parametrize("width,n,message", [
    (2656, 4, "phase-aligned"),  # 664 columns: 41.5 at stride 16
    (2656, 8, "phase-aligned"),  # 332 columns: 20.75 at stride 16
    (64, 2, "halo"),  # 2 columns at stride 16, the deconv takes 4
])
def test_refused_width_splits(width, n, message):
    with pytest.raises(ValueError, match=message):
        pdist.check_width_split(width, n, (1, 2, 4), WIDTH_STRIDE,
                                DECONV_HALO)


def test_the_recipe_splits_in_two():
    assert pdist.check_width_split(2656, 2, (1, 2, 4), WIDTH_STRIDE,
                                   DECONV_HALO) == 1328
    assert pdist.check_mesh({"model": 2}, 2) == (1, 2)
    assert pdist.check_mesh(None, 3) == (3, 1)
