"""The port's host augmentation (data/augment.py and its hook in
data/waymo.py:record_to_inputs) against the JAX package's, on the CPU at
small sizes: world_flip, world_rotation and apply_augmentations bit-equal
under seeded generators (both branches of the flip's draw, the same draws
left on the generator), the geometry they keep, record_to_inputs with the
recipe's augmentation on files from write_waymo_files, and the train loop
drawing from the global np.random, as the JAX loop does."""
import contextlib
import io
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rangedet_tpu.data import augment as jaugment
from rangedet_tpu.data import waymo as jwaymo
from rangedet_tpu.data.synthetic import make_frame as jax_make_frame
from rangedet_tpu.ops import assigner as jassigner
from rangedet_tpu.ops import boxes as jboxes
from rangedet_tpu_torch.configs import load_config
from rangedet_tpu_torch.data import augment as taugment
from rangedet_tpu_torch.data import waymo as twaymo
from rangedet_tpu_torch.data.synthetic import make_frame, write_waymo_files
from rangedet_tpu_torch.tools import train as train_cli
from torch_parity import TINY_PORT_CONFIG

# one intra-op thread per test process: several workers share the cores
torch.set_num_threads(1)

H, W = 16, 128  # the tiny recipe's feat_size and pad_field
SEEDS = range(6)
# the multiclass recipe's augmentation
AUGMENT = ("flip", "rotation")


def _frame(seed=0):
    """A raw frame dict as record_to_inputs builds it: inclination a
    read-only broadcast view, the image channels, points, azimuth, GT."""
    f = make_frame(np.random.RandomState(100 + seed), H, W, 5, (1, 2, 4))
    f["elongation"] = np.random.RandomState(seed).rand(H, W).astype(
        np.float32)
    f["is_in_nlz"] = np.where(np.arange(W)[None] < W // 4, 1.0,
                              -1.0).astype(np.float32) * np.ones((H, 1),
                                                                 np.float32)
    f["inclination"] = np.broadcast_to(f["inclination"][:, :1], (H, W))
    return f


def _assert_frames_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_the_port_keeps_the_references_registry_and_channels():
    assert sorted(taugment.AUGMENTATIONS) == sorted(jaugment.AUGMENTATIONS)
    assert taugment._IMAGE_KEYS == jaugment._IMAGE_KEYS


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", ["flip", "rotation"])
def test_augmentation_is_bit_equal_to_jax(name, seed):
    frame = _frame(seed)
    snapshot = {k: np.array(v) for k, v in frame.items()}
    rng_t, rng_j = (np.random.RandomState(seed) for _ in range(2))
    got = taugment.AUGMENTATIONS[name](frame, rng_t)
    want = jaugment.AUGMENTATIONS[name](_frame(seed), rng_j)
    _assert_frames_equal(got, want)
    # the same draws: both generators stand at the same state afterwards
    assert rng_t.uniform() == rng_j.uniform()
    # the input frame is left as it came (inclination is a broadcast view)
    _assert_frames_equal({k: np.array(v) for k, v in frame.items()},
                         snapshot)


def test_flip_seeds_take_both_branches():
    flipped = [np.random.RandomState(s).uniform() < 0.5 for s in SEEDS]
    assert any(flipped) and not all(flipped)
    for s, f in zip(SEEDS, flipped):
        frame = _frame(s)
        out = taugment.world_flip(frame, np.random.RandomState(s))
        assert (out is not frame) == f


@pytest.mark.parametrize("seed", SEEDS[:3])
@pytest.mark.parametrize("names", [("flip",), ("rotation",), AUGMENT])
def test_apply_augmentations_is_bit_equal_to_jax(names, seed):
    rng_t, rng_j = (np.random.RandomState(seed) for _ in range(2))
    got = taugment.apply_augmentations(_frame(seed), rng_t, names)
    want = jaugment.apply_augmentations(_frame(seed), rng_j, names)
    _assert_frames_equal(got, want)
    assert rng_t.uniform() == rng_j.uniform()


def _contained(frame):
    """The points assigned to a GT box (the JAX assigner, as
    tests/test_augment_builder.py counts them)."""
    corners8 = jboxes.csa_to_corners3d(jnp.asarray(frame["gt_csa"]))
    idx = np.asarray(jassigner.assign_points_to_boxes(
        jnp.asarray(frame["pc"].reshape(-1, 3)), corners8,
        jnp.asarray(frame["mask"].reshape(-1))))
    return (idx >= 0).sum()


def test_world_flip_preserves_containment(rng):
    # the port's copy of tests/test_augment_builder.py's flip case
    frame = jax_make_frame(rng, H=32, W=256, num_boxes=5)
    n0 = _contained(frame)
    flipped = taugment.world_flip(frame, rng, prob=1.0)
    assert _contained(flipped) >= 0.9 * n0 > 0
    assert np.allclose(flipped["pc"][..., 1], -frame["pc"][:, ::-1, 1])


def test_world_rotation_preserves_containment(rng):
    # the port's copy of tests/test_augment_builder.py's rotation case
    frame = jax_make_frame(rng, H=32, W=256, num_boxes=5)
    n0 = _contained(frame)
    rot = taugment.world_rotation(frame, rng)
    assert _contained(rot) >= 0.9 * n0 > 0
    r0 = np.linalg.norm(frame["pc"], axis=-1)
    r1 = np.linalg.norm(rot["pc"], axis=-1)
    assert np.allclose(np.sort(r0.ravel()), np.sort(r1.ravel()), atol=1e-4)


@pytest.mark.parametrize("seed", [0, 1])
def test_both_augmentations_preserve_containment(seed):
    frame = jax_make_frame(np.random.RandomState(seed), H=32, W=256,
                           num_boxes=5)
    out = taugment.apply_augmentations(frame, np.random.RandomState(seed),
                                       AUGMENT)
    assert _contained(out) >= 0.9 * _contained(frame) > 0


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("augment")
    data = str(root / "data")
    write_waymo_files(data, 3, H=H, W=W, seed=4, image_set="training",
                      num_boxes=6, class_choices=(1, 2, 4))
    recipe = root / "tiny_augmenting_recipe.py"
    recipe.write_text(TINY_PORT_CONFIG.replace(
        '"rangedet_veh_wo_aug_4_18e"', '"rangedet_multiclass_all_36e"'
    ).replace('device_topk={"veh": 256}',
              'device_topk={"veh": 256, "ped": 256, "cyc": 256}'))
    return dict(data=data, recipe=str(recipe),
                roidb=twaymo.load_roidbs(data, "training"))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_record_to_inputs_with_the_recipes_augmentation_matches_jax(
        files, seed):
    cfg = load_config("rangedet_multiclass_all_36e")
    assert tuple(cfg.augment) == AUGMENT
    for rec in files["roidb"]:
        got = twaymo.record_to_inputs(rec, (H, W), 32, augment=cfg.augment,
                                      aug_rng=np.random.RandomState(seed))
        want = jwaymo.record_to_inputs(rec, (H, W), 32, augment=cfg.augment,
                                       aug_rng=np.random.RandomState(seed))
        _assert_frames_equal(got, want)
        plain = twaymo.record_to_inputs(rec, (H, W), 32)
        assert not np.array_equal(got["input_data"], plain["input_data"])


def test_record_to_inputs_without_aug_rng_draws_the_global_generator(files):
    rec = files["roidb"][0]
    np.random.seed(7)
    got = twaymo.record_to_inputs(rec, (H, W), 32, augment=AUGMENT)
    np.random.seed(7)
    want = jwaymo.record_to_inputs(rec, (H, W), 32, augment=AUGMENT)
    _assert_frames_equal(got, want)


def test_no_augmentation_is_byte_identical_to_the_plain_path(files):
    for rec in files["roidb"]:
        plain = twaymo.record_to_inputs(rec, (H, W), 32)
        with mock.patch.object(taugment, "apply_augmentations") as hook:
            got = twaymo.record_to_inputs(rec, (H, W), 32, augment=(),
                                          aug_rng=np.random.RandomState(0))
        hook.assert_not_called()
        _assert_frames_equal(got, plain)
        _assert_frames_equal(got, jwaymo.record_to_inputs(rec, (H, W), 32))


def test_the_loop_draws_from_the_global_generator(files, tmp_path):
    """tools.train leaves aug_rng unset, as tools/train.py:281 does, so each
    mapped training frame draws twice from np.random: the flip's uniform(),
    then the rotation's uniform(-pi/4, pi/4)."""
    draws, mapped = [], []
    real_uniform, real_map = np.random.uniform, twaymo.record_to_inputs

    def uniform(*a, **kw):
        draws.append(a)
        return real_uniform(*a, **kw)

    def record_to_inputs(rec, *a, **kw):
        mapped.append((kw.get("augment"), kw.get("aug_rng")))
        return real_map(rec, *a, **kw)

    with mock.patch.object(np.random, "uniform", uniform), \
            mock.patch.object(twaymo, "record_to_inputs", record_to_inputs), \
            contextlib.redirect_stdout(io.StringIO()):
        hist, _, _ = train_cli.main([
            "--config", files["recipe"], "--data-root", files["data"],
            "--sampling-rate", "1", "--batch", "1", "--epochs", "1",
            "--steps-per-epoch", "1", "--num-workers", "1",
            "--experiment-dir", str(tmp_path), "--device", "cpu"])
    assert len(hist) == 1 and np.isfinite(hist[0]["total_loss"])
    assert mapped and set(mapped) == {(AUGMENT, None)}
    lim = np.pi / 4
    assert draws == [(), (-lim, lim)] * len(mapped)
