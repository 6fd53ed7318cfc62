"""The port's packed frame cache and on-device augmentation
(data/device_cache.py) and the train CLI's --device-cache path against the
JAX package's device_cache, on the CPU at a tiny size: pack_inputs
bit-equal, unpack / finalize / expand equal on the integer and flag planes
and within 1e-6 elsewhere, exact padding zeros, the gather, augment_raw
under explicit draws against JAX's and against the port's host
augmentation within the codec's budgets, the train targets of a
device-augmented batch against the host's outside the codec's band, and
the CLI: 2 cached steps with device augmentation, a resume drawing what an
unbroken run draws, the cached validation, and the refusal of the recipe's
host augmentation."""
import contextlib
import io
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from rangedet_tpu.data import device_cache as jdc
from rangedet_tpu_torch.configs import load_config
from rangedet_tpu_torch.data import device_cache as tdc
from rangedet_tpu_torch.data.synthetic import write_waymo_files
from rangedet_tpu_torch.data.waymo import record_to_inputs
from rangedet_tpu_torch.models.detector import build_train_targets
from rangedet_tpu_torch.tools import train as train_cli
from torch_parity import TINY_PORT_CONFIG

# one intra-op thread per test process: several workers share the cores
torch.set_num_threads(1)

H, W, PAD = 16, 120, (16, 128)  # frames narrower than the pad: zero columns
MAX_GT = 32
N_FRAMES = 4
AUGMENT = ("flip", "rotation")
EXACT = ("mask", "is_in_nlz", "gt_csa", "gt_class", "gt_valid", "col_ok",
         "flags")
FLOAT_TOL = 1e-6

@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("device_cache")
    data = str(root / "data")
    recs = write_waymo_files(data, N_FRAMES, H=H, W=W, seed=3,
                             image_set="training", num_boxes=6)
    write_waymo_files(data, 2, H=H, W=W, seed=4, image_set="validation",
                      num_boxes=6)
    recipe = root / "tiny_recipe.py"
    recipe.write_text(TINY_PORT_CONFIG)
    return dict(root=root, data=data, recs=recs, recipe=str(recipe))


def _fulls(recs, **kw):
    return [record_to_inputs(r, PAD, MAX_GT, **kw) for r in recs]


def _packed(recs):
    return tdc.stack_packed([tdc.pack_inputs(f) for f in _fulls(recs)])


def _cpu(packed):
    return tdc.to_device(packed, torch.device("cpu"))


def _np(d):
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in d.items()}


def _assert_matches(got, want, tol=FLOAT_TOL):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.broadcast_to(np.asarray(want[k]),
                                                   np.shape(got[k]))
        if k in EXACT or w.dtype == bool or np.issubdtype(w.dtype,
                                                          np.integer):
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=k)


def test_pack_inputs_is_bit_equal_and_keeps_jax_bytes(files):
    for full in _fulls(files["recs"]):
        got, want = tdc.pack_inputs(full), jdc.pack_inputs(full)
        assert list(got) == list(want) == list(tdc.PACKED_KEYS)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    cache = _cpu(_packed(files["recs"]))
    # the image planes: 11 bytes a pixel (pc 3 x 2, range 2 as packed,
    # intensity, elongation, flags 1 each)
    assert cache["range_q"].dtype == torch.int16
    planes = [v for v in cache.values() if tuple(v.shape[-2:]) == PAD]
    nbytes = sum(v.numel() * v.element_size() for v in planes)
    assert nbytes == 11 * N_FRAMES * PAD[0] * PAD[1]


@pytest.mark.parametrize("stage", ["unpack_raw", "finalize_inputs",
                                   "expand_inputs"])
def test_unpack_finalize_expand_match_jax(files, stage):
    packed = _packed(files["recs"])
    cache = _cpu(packed)
    jin = {k: jnp.asarray(v) for k, v in packed.items()}
    if stage == "unpack_raw":
        got, want = tdc.unpack_raw(cache, W), jdc.unpack_raw(jin, W)
    elif stage == "finalize_inputs":
        got = tdc.finalize_inputs(tdc.unpack_raw(cache, W))
        want = jdc.finalize_inputs(jdc.unpack_raw(jin, W))
    else:
        got, want = tdc.expand_inputs(cache, W), jdc.expand_inputs(jin, W)
    _assert_matches(_np(got), _np(want))


def test_padding_zeros_are_exact(files):
    out = _np(tdc.expand_inputs(_cpu(_packed(files["recs"][:1])), W))
    for k in ("input_data", "coord", "pc", "mask", "unnorm_range",
              "is_in_nlz"):
        assert np.abs(out[k][:, :, W:]).max() == 0.0, k
    assert np.abs(out["input_data"][:, :, :W]).max() > 0


def test_gather_selects_frames(files):
    packed = _packed(files["recs"])
    cache = _cpu(packed)
    sub = tdc.gather_packed(cache, torch.tensor([3, 0, 2]))
    for k, v in packed.items():
        got = sub[k].numpy()
        if v.dtype == np.uint16:
            got = got.view(np.uint16)
        np.testing.assert_array_equal(got, v[[3, 0, 2]], err_msg=k)
    jsub = jdc.gather_packed({k: jnp.asarray(v) for k, v in packed.items()},
                             jnp.asarray([3, 0, 2]))
    _assert_matches(_np(tdc.expand_inputs(sub, W)),
                    _np(jdc.expand_inputs(jsub, W)))


def _host_draws(seed0, n, w):
    """data/augment.py's draws under RandomState(seed0 + i): flip's one
    uniform, then rotation's theta quantized to whole columns."""
    flips, shifts = [], []
    for i in range(n):
        r = np.random.RandomState(seed0 + i)
        flips.append(bool(r.uniform() < 0.5))
        theta = float(r.uniform(-np.pi / 4, np.pi / 4))
        shifts.append(int(round(theta / (2 * np.pi) * w)))
    return flips, shifts


SEED0 = 0  # draws with a flip and without, shifts both ways


def test_augment_raw_matches_jax_under_explicit_draws(files):
    flips, shifts = _host_draws(SEED0, N_FRAMES, W)
    assert any(flips) and not all(flips) and min(shifts) < 0 < max(shifts)
    packed = _packed(files["recs"])
    got = tdc.augment_raw(tdc.unpack_raw(_cpu(packed), W), W,
                          do_flip=torch.tensor(flips),
                          shift=torch.tensor(shifts, dtype=torch.int32))
    want = jdc.augment_raw(
        jdc.unpack_raw({k: jnp.asarray(v) for k, v in packed.items()}, W),
        W, do_flip=jnp.asarray(flips), shift=jnp.asarray(shifts, jnp.int32))
    _assert_matches(_np(got), _np(want), tol=1e-5)
    _assert_matches(_np(tdc.finalize_inputs(got)),
                    _np(jdc.finalize_inputs(want)), tol=1e-5)


def _augmented_pair(recs):
    """(host batch: record_to_inputs with the recipe's augmentation under
    RandomState(SEED0 + i); cached batch: pack -> unpack -> augment_raw
    with the matched draws -> finalize), tensors on the CPU."""
    flips, shifts = _host_draws(SEED0, len(recs), W)
    host = [record_to_inputs(r, PAD, MAX_GT, augment=AUGMENT,
                             aug_rng=np.random.RandomState(SEED0 + i))
            for i, r in enumerate(recs)]
    host = {k: torch.from_numpy(np.stack([h[k] for h in host]))
            for k in host[0]}
    raw = tdc.augment_raw(tdc.unpack_raw(_cpu(_packed(recs)), W), W,
                          do_flip=torch.tensor(flips),
                          shift=torch.tensor(shifts, dtype=torch.int32))
    return host, tdc.finalize_inputs(raw)


def test_augment_raw_matches_the_host_augmentation(files):
    host, cached = _augmented_pair(files["recs"])
    worst = chip_smoke.codec_check(_np(host), _np(cached), rotated=True)
    assert max(worst) > 0  # the codec moved something


def test_expand_matches_record_to_inputs_within_the_codec(files):
    fulls = _fulls(files["recs"])
    host = {k: np.stack([f[k] for f in fulls]) for k in fulls[0]}
    cached = _np(tdc.expand_inputs(_cpu(_packed(files["recs"])), W))
    chip_smoke.codec_check(host, cached)


def test_targets_of_a_device_rotated_batch_equal_the_host_targets(files):
    cfg = load_config(files["recipe"], is_train=True).replace(
        pad_field=PAD, max_gt_boxes=MAX_GT)
    host, cached = _augmented_pair(files["recs"])
    out = chip_smoke.cached_targets_check(torch, build_train_targets, cfg,
                                          host, cached)
    # a raytraced point sits 5 mm along its ray inside the face it hit:
    # oblique hits lie in the 2.44 mm face band, and a few of them cross
    assert 0 < out["band_face_px"] < 0.05 * host["mask"].sum()
    assert out["differ_px"] <= out["band_face_px"] + out["band_bound_px"]
    assert out["count_shift"] <= out["band_face_px"]
    assert sum(out["reg_err"]) > 0  # the codec moved the targets


def test_draws_from_a_generator(files):
    raw = tdc.unpack_raw(_cpu(_packed(files["recs"])), W)
    g = torch.Generator().manual_seed(0)
    flips, shifts = tdc.draw_augment(64, W, g)
    assert 0 < int(flips.sum()) < 64
    assert shifts.abs().max() <= W // 8 and shifts.dtype == torch.int32
    out = tdc.augment_raw(raw, W, generator=torch.Generator().manual_seed(0))
    f, sh = tdc.draw_augment(N_FRAMES, W, torch.Generator().manual_seed(0))
    want = tdc.augment_raw(raw, W, do_flip=f, shift=sh)
    for k in out:
        assert torch.equal(out[k], want[k]), k


def _train(files, exp, *argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        hist, state, val = train_cli.main([
            "--config", files["recipe"], "--data-root", files["data"],
            "--device", "cpu", "--batch", "2", "--sampling-rate", "1",
            "--experiment-dir", exp, *argv])
    return hist, state, val, out.getvalue()


def test_train_cli_device_cache_resume_draws_as_an_unbroken_run(files):
    exp = str(files["root"] / "exp")
    draws, gathered = [], []
    real_draw, real_gather = tdc.draw_augment, tdc.gather_packed

    def draw(*a, **kw):
        out = real_draw(*a, **kw)
        draws.append(tuple(t.tolist() for t in out))
        return out

    def gather(cache, idx):
        gathered.append(idx.tolist())
        return real_gather(cache, idx)

    cached = ["--device-cache", "--device-augment", "flip,rotation"]
    with mock.patch.object(tdc, "draw_augment", draw), \
            mock.patch.object(tdc, "gather_packed", gather):
        hist0, _, val0, text0 = _train(files, exp, "--epochs", "1",
                                       *cached)
        hist1, state, val1, text1 = _train(
            files, exp, "--epochs", "2", "--resume", "--eval-every", "1",
            "--eval-frames", "2", *cached)
    hist = hist0 + hist1
    assert [h["step"] for h in hist] == [0, 1, 2, 3] and state.step == 4
    assert all(np.isfinite(h["total_loss"]) for h in hist)
    assert "device cache staged: 4 frames" in text0
    assert "resumed from epoch 0" in text1
    # the augmentation of step n draws from (seed + 7, n) alone
    want = [tuple(t.tolist() for t in real_draw(
        2, W, train_cli.augment_generator(0, n, torch.device("cpu"))))
        for n in range(4)]
    assert draws == want
    assert any(f for d in draws for f in d[0])
    # each epoch's frames: RandomState(seed * 100003 + epoch).permutation
    orders = [np.random.RandomState(e).permutation(N_FRAMES) for e in (0, 1)]
    train_idx = [g for g in gathered if len(g) == 2]
    assert train_idx == [orders[0][:2].tolist(), orders[0][2:].tolist(),
                         orders[1][:2].tolist(), orders[1][2:].tolist()]
    # the validation's 2 frames, gathered one at a time from their cache
    assert [g for g in gathered if len(g) == 1] == [[0], [1]]
    assert list(val1) == [1] and val0 == {}
    assert all(np.isfinite(v) for m in val1[1].values() for v in m.values())


def test_device_cache_refuses_the_recipes_host_augmentation(files):
    recipe = files["root"] / "augmented_recipe.py"
    recipe.write_text(TINY_PORT_CONFIG.replace(
        "dtype=torch.float32,", "dtype=torch.float32, augment=('flip',),"))
    with pytest.raises(SystemExit, match="pre-augmentation"):
        train_cli.main(["--config", str(recipe), "--data-root",
                        files["data"], "--device", "cpu", "--experiment-dir",
                        str(files["root"] / "exp_aug"), "--device-cache"])
    with pytest.raises(SystemExit, match="--device-augment"):
        train_cli.main(["--config", files["recipe"], "--device", "cpu",
                        "--device-augment", "flip"])
    # synthetic data takes the cache's place: its augmentation is refused,
    # not dropped
    with pytest.raises(SystemExit, match="needs the device cache"):
        train_cli.main(["--config", files["recipe"], "--data-root",
                        files["data"], "--device", "cpu", "--experiment-dir",
                        str(files["root"] / "exp_syn"), "--synthetic",
                        "--device-cache", "--device-augment", "flip"])
