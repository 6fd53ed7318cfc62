"""The port's train loop (tools/train.py, data/loader.py, data/prefetch.py)
against the JAX package's, on the CPU at the tiny recipe: the loader's
batches, the threads a cut-short epoch leaves, the loop's steps,
checkpoints and LR, an exact resume, the first batch the loop trains on
from files and that batch's step against JAX's, and the chain train ->
resume with validation -> test -> bin -> AP on files written with both
splits under one root."""
import contextlib
import io
import json
import os
import threading
import types
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rangedet_tpu.configs import load_config as jax_load_config
from rangedet_tpu.data import waymo as jwaymo
from rangedet_tpu.data.loader import BatchLoader as JaxLoader
from rangedet_tpu.models import RangeDet as JaxRangeDet
from rangedet_tpu.train.schedule import build_optimizer as jax_optimizer
from rangedet_tpu.train.schedule import build_schedule as jax_schedule
from rangedet_tpu.train.state import TrainState as JaxTrainState
from rangedet_tpu.train.train_step import make_train_step as jax_step
from rangedet_tpu_torch.configs import load_config
from rangedet_tpu_torch.convert import to_flax
from rangedet_tpu_torch.data.loader import BatchLoader
from rangedet_tpu_torch.data.prefetch import threaded_prefetch
from rangedet_tpu_torch.data.synthetic import write_waymo_files
from rangedet_tpu_torch.models import RangeDet
from rangedet_tpu_torch.tools import train as train_cli
from rangedet_tpu_torch.train import checkpoint as tckpt
from rangedet_tpu_torch.train import train_step as ttrain_step
from rangedet_tpu_torch.train.state import create_train_state
from tiny import tiny_config
from torch_parity import TINY_PORT_CONFIG, perturb, port_config, port_model

# one intra-op thread per test process: several workers share the cores
torch.set_num_threads(1)

H, W = 16, 128  # the tiny recipe's feat_size and pad_field
N_TRAIN, N_VAL = 4, 3
# tests/test_torch_train.py's bound on one step's metrics, port vs JAX
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A training and a validation split under one root, and the tiny
    recipe file."""
    root = tmp_path_factory.mktemp("train_loop")
    data = str(root / "data")
    train = write_waymo_files(data, N_TRAIN, H=H, W=W, seed=1,
                              image_set="training")
    val = write_waymo_files(data, N_VAL, H=H, W=W, seed=2,
                            image_set="validation")
    recipe = root / "tiny_recipe.py"
    recipe.write_text(TINY_PORT_CONFIG)
    return dict(root=root, data=data, recipe=str(recipe), train=train,
                val=val)


def _train(files, *argv):
    """tools.train on the tiny recipe on the CPU -> (history, state,
    validations, stdout)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        hist, state, val = train_cli.main(
            ["--config", files["recipe"], "--device", "cpu", *argv])
    return hist, state, val, out.getvalue()


# ---------------------------------------------------------------- loader
def _records(n):
    return [{"i": i} for i in range(n)]


def _map(rec):
    i = rec["i"]
    return {"x": np.full((2, 3), i, np.float32), "i": np.int32(i)}


@pytest.mark.parametrize("host_id", [0, 1])
@pytest.mark.parametrize("drop_last", [True, False])
def test_loader_gives_the_jax_batches(drop_last, host_id):
    kw = dict(batch_size=3, num_workers=1, seed=5, host_id=host_id,
              num_hosts=2, drop_last=drop_last)
    got, want = (cls(_records(23), _map, **kw)
                 for cls in (BatchLoader, JaxLoader))
    # 11 records a host: 3 full batches and one of 2
    assert len(got) == len(want) == (3 if drop_last else 4)
    orders = []
    for _ in range(2):
        g, w = list(got.epoch()), list(want.epoch())
        assert len(g) == len(w) == len(got)
        for a, b in zip(g, w):
            assert sorted(a) == sorted(b)
            for k in b:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        ids = np.concatenate([b["i"] for b in g])
        assert set(ids) <= set(range(11 * host_id, 11 * host_id + 11))
        orders.append(ids.tolist())
    assert orders[0] != orders[1]  # a shuffle an epoch


@pytest.mark.parametrize("through_prefetch", [False, True])
def test_loader_error_raises_in_the_consumer(through_prefetch):
    def bad(rec):
        if rec["i"] == 4:
            raise ValueError("bad record 4")
        return _map(rec)

    before = set(threading.enumerate())
    batches = BatchLoader(_records(8), bad, batch_size=2, num_workers=2,
                          seed=0).epoch()
    if through_prefetch:
        batches = threaded_prefetch(batches)
    with pytest.raises(ValueError, match="bad record 4"):
        list(batches)
    assert not set(threading.enumerate()) - before


@pytest.mark.parametrize("host_id", [0, 1])
def test_several_workers_give_each_epoch_the_jax_frames(host_id):
    # batch composition follows thread timing here (data/loader.py), so
    # each epoch is compared as a multiset of frames, not as an order
    kw = dict(batch_size=4, num_workers=3, seed=2, host_id=host_id,
              num_hosts=2, drop_last=False)
    got, want = (cls(_records(26), _map, **kw)
                 for cls in (BatchLoader, JaxLoader))
    for _ in range(2):
        g = [b["i"] for b in got.epoch()]
        w = [b["i"] for b in want.epoch()]
        assert [len(b) for b in g] == [len(b) for b in w] == [4, 4, 4, 1]
        assert sorted(np.concatenate(g)) == sorted(np.concatenate(w)) == \
            list(range(13 * host_id, 13 * host_id + 13))


def test_cut_short_epochs_leave_no_thread():
    loader = BatchLoader(_records(64), _map, batch_size=2, num_workers=4,
                         prefetch=2, seed=0)
    before = set(threading.enumerate())
    n_before = threading.active_count()
    for _ in range(3):  # two steps of each epoch, as --steps-per-epoch 2
        batches = threaded_prefetch(loader.epoch(), depth=2)
        next(batches)
        next(batches)
        batches.close()
    assert not set(threading.enumerate()) - before
    assert threading.active_count() <= n_before


# ---------------------------------------------------------------- loop
def test_loop_steps_checkpoints_and_lr_follow_jax(files, tmp_path):
    hist, state, val, _ = _train(
        files, "--synthetic", "--epochs", "3", "--steps-per-epoch", "2",
        "--checkpoint-every", "2", "--experiment-dir", str(tmp_path))
    assert state.step == 6 and val == {}
    assert [(r["epoch"], r["step"]) for r in hist] == [
        (0, 0), (0, 1), (1, 2), (1, 3), (2, 4), (2, 5)]
    cfg = load_config(files["recipe"], is_train=True).replace(
        experiment_dir=str(tmp_path))
    assert os.listdir(tckpt.checkpoint_dir(cfg)) == ["torch_epoch_0001.pt"]
    ckpt = torch.load(tckpt.checkpoint_path(cfg, 1), weights_only=True)
    assert (ckpt["epoch"], ckpt["step"]) == (1, 4)
    # tools/train.py's LR: the recipe's schedule over 3 epochs of 2 steps,
    # base_lr scaled by the batch (auto_scale_lr)
    jcfg = jax_load_config("rangedet_veh_wo_aug_4_18e", True).replace(
        end_epoch=3)
    jcfg = jcfg.replace(base_lr=jcfg.base_lr * cfg.batch_image / 16.0)
    want = jax_schedule(jcfg, 2)
    np.testing.assert_allclose([r["lr"] for r in hist],
                               [float(want(c)) for c in range(6)],
                               rtol=1e-6, atol=1e-9)
    assert all(np.isfinite(r["total_loss"]) for r in hist)


@pytest.mark.parametrize("argv,msg", [
    (("--sampling-rate", "0"), "--sampling-rate must be >= 1"),
    (("--checkpoint-every", "-1"), "--checkpoint-every must be >= 0"),
])
def test_bad_overrides_exit(files, argv, msg):
    with pytest.raises(SystemExit, match=msg):
        train_cli.main(["--config", files["recipe"], "--synthetic",
                        "--device", "cpu", *argv])


def test_cuda_without_a_card_exits(files):
    with mock.patch.object(torch.cuda, "is_available", lambda: False), \
            pytest.raises(SystemExit, match="no CUDA card"):
        train_cli.main(["--config", files["recipe"], "--synthetic"])


def test_resume_is_exact(files, tmp_path):
    exp = str(tmp_path)
    common = ("--synthetic", "--steps-per-epoch", "2", "--experiment-dir",
              exp)
    _train(files, "--epochs", "1", *common)
    hist, state, _, out = _train(files, "--epochs", "3", "--resume", *common)
    assert "resumed from epoch 0" in out
    assert [r["step"] for r in hist] == [2, 3, 4, 5] and state.step == 6
    cfg = load_config(files["recipe"], is_train=True).replace(
        experiment_dir=exp, end_epoch=3)
    assert tckpt.latest_epoch(cfg) == 2
    assert sorted(os.listdir(tckpt.checkpoint_dir(cfg))) == [
        f"torch_epoch_{e:04d}.pt" for e in range(3)]

    # the reference: checkpoint 0 in a state whose schedule ends at epoch
    # 3, stepped over epochs 1-2's synthetic batches
    cfg = cfg.replace(base_lr=cfg.base_lr * cfg.batch_image / 16.0)
    ref = create_train_state(RangeDet(**cfg.model_kwargs()), cfg, 2, seed=1)
    _, ep = tckpt.restore_checkpoint(ref, cfg, 0)
    assert ep == 0 and ref.step == 2
    step = ttrain_step.make_train_step(ref, cfg)
    want = [step(ttrain_step.batch_to_device(
        train_cli.synthetic_batch(cfg, e, i), torch.device("cpu")))
        for e in (1, 2) for i in (0, 1)]
    for got, w in zip(hist, want):
        for k, v in w.items():
            assert got[k] == float(v), k  # bit-equal
    sa, sb = state.model.state_dict(), ref.model.state_dict()
    assert sorted(sa) == sorted(sb)
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    oa, ob = state.optimizer.state_dict(), ref.optimizer.state_dict()
    assert sorted(oa["state"]) == sorted(ob["state"]) and oa["state"]
    for k in oa["state"]:
        assert torch.equal(oa["state"][k]["momentum_buffer"],
                           ob["state"][k]["momentum_buffer"])


# ---------------------------------------------------------------- slice
def _jax_step_cfg():
    # tests/test_torch_train.py's step: tiny bhcw in f32, the materialized
    # Meta-Kernel, the dense IoU target on the JAX side
    return tiny_config(layout="bhcw", dtype=jnp.float32,
                       use_pallas_meta=False, use_pallas_iou=False,
                       iou_topk_gt=0).replace(base_lr=0.01, warmup_epochs=0)


def test_first_trained_batch_and_its_step_are_the_jax_loops(files, tmp_path):
    seen = []
    real = ttrain_step.batch_to_device

    def record(batch, device):
        seen.append(batch)
        return real(batch, device)

    with mock.patch.object(ttrain_step, "batch_to_device", record):
        _train(files, "--data-root", files["data"], "--sampling-rate", "1",
               "--epochs", "1", "--steps-per-epoch", "1", "--num-workers",
               "1", "--checkpoint-every", "0", "--experiment-dir",
               str(tmp_path))
    # the prefetch thread puts the epoch's batches ahead of the steps (the
    # loader's 2 here); the first put is the batch the one step trains on
    assert len(seen) == 2
    got = seen[0]

    # tools/train.py: its loader over the training split; the sample batch
    # it initialises from spends the first epoch() call
    cfg = load_config(files["recipe"], is_train=True)
    roidb = jwaymo.load_roidbs(files["data"], cfg.image_set, 1,
                               cfg.filter_class)
    loader = JaxLoader(roidb, lambda rec: jwaymo.record_to_inputs(
        rec, cfg.pad_field, cfg.max_gt_boxes, augment=cfg.augment),
        batch_size=cfg.batch_image, num_workers=1)
    sample = next(iter(loader.epoch()))
    want = next(iter(loader.epoch()))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the two permutations start on other frames, so the check above
    # tells epoch 0 from the loader's first shuffle
    assert not np.array_equal(sample["gt_csa"], want["gt_csa"])

    # one step of each side on that batch, the same weights
    jcfg = _jax_step_cfg()
    pcfg = port_config(jcfg)
    model = RangeDet(**pcfg.model_kwargs())
    model.init_from(torch.Generator().manual_seed(0))
    params, stats = to_flax(model.state_dict())
    params, stats = perturb({"params": params, "batch_stats": stats},
                            seed=3)
    jmodel = JaxRangeDet(**jcfg.model_kwargs())
    tx, _ = jax_optimizer(jcfg, 100)
    jstate = JaxTrainState.create(apply_fn=jmodel.apply, params=params,
                                  batch_stats=stats, tx=tx)
    _, jm = jax.jit(jax_step(jmodel, jcfg))(
        jstate, {k: jnp.asarray(a) for k, a in want.items()})
    state = create_train_state(port_model(pcfg, params, stats), pcfg, 100,
                               seed=None)
    tm = ttrain_step.make_train_step(state, pcfg)(
        ttrain_step.batch_to_device(got, torch.device("cpu")))
    assert sorted(tm) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), err_msg=k,
                                   **LOSS_TOL)


def test_resumed_run_redraws_the_first_epochs_frames_as_jax_does(
        files, tmp_path):
    # tools/train.py's loader is seeded 0 afresh in every process, so a
    # resumed run's first epoch draws the frames an uninterrupted run's
    # epoch 0 drew; the port keeps that
    seen = []
    real = ttrain_step.batch_to_device

    def record(batch, device):
        seen.append(batch)
        return real(batch, device)

    common = ("--data-root", files["data"], "--sampling-rate", "1",
              "--steps-per-epoch", "1", "--num-workers", "1",
              "--experiment-dir", str(tmp_path))
    with mock.patch.object(ttrain_step, "batch_to_device", record):
        _train(files, "--epochs", "1", *common)
        _, state, _, out = _train(files, "--epochs", "2", "--resume",
                                  *common)
    assert "resumed from epoch 0" in out and state.step == 2
    # each run's prefetch thread puts the epoch's 2 batches ahead of its
    # one step, the first of them trained on
    first = seen[::2]
    assert len(seen) == 4
    assert len(first) == 2 and sorted(first[0]) == sorted(first[1])
    for k in first[0]:
        np.testing.assert_array_equal(first[0][k], first[1][k], err_msg=k)


def _chain(recipe, data, val_ids, tmp_path):
    """train an epoch -> --resume with validation -> test -> bin -> AP, from
    the splits under ``data``: 4 training frames (2 steps of B=2 an epoch)
    and the validation frames ``val_ids``."""
    from rangedet_tpu.eval.waymo_bin import load_prediction_pickle
    from rangedet_tpu_torch.tools import create_prediction_bin_3d
    from rangedet_tpu_torch.tools import evaluate_pred
    from rangedet_tpu_torch.tools import test as test_cli

    exp = str(tmp_path / "exp")
    files = dict(recipe=recipe)
    common = ("--data-root", data, "--sampling-rate", "1",
              "--num-workers", "2", "--experiment-dir", exp)
    before = set(threading.enumerate())
    hist0, _, _, out0 = _train(files, "--epochs", "1", *common)
    hist, state, val, out = _train(files, "--epochs", "2", "--resume",
                                   "--eval-every", "1", "--eval-frames",
                                   str(len(val_ids)), *common)
    assert not set(threading.enumerate()) - before
    # len(loader) steps an epoch: 4 frames at B=2
    assert [r["step"] for r in hist0 + hist] == [0, 1, 2, 3]
    assert state.step == 4
    assert "resumed from epoch 0" in out
    assert list(val) == [1] and f"epoch 1 validation: {val[1]}" in out
    assert sorted(val[1]) == ["veh"] and all(
        np.isfinite(v) for v in val[1]["veh"].values())

    pred = str(tmp_path / "pred.pkl")
    with contextlib.redirect_stdout(io.StringIO()) as tout:
        test_cli.main(["--config", recipe, "--data-root", data,
                       "--image-set", "validation", "--batch", "2",
                       "--experiment-dir", exp, "--epoch", "1",
                       "--device", "cpu", "--output", pred])
    assert "checkpoint epoch 1" in tout.getvalue()
    anno, outputs = load_prediction_pickle(pred)
    assert sorted(outputs) == sorted(anno) == sorted(val_ids)
    n = create_prediction_bin_3d.main(["--pred", pred, "--out",
                                       str(tmp_path / "pred.json")])
    with open(tmp_path / "pred.json") as f:
        assert len(json.load(f)) == n == sum(
            len(o["det_xyzlwhyaws"]["veh"]) for o in outputs.values())
    records = evaluate_pred.main(["--config", recipe, "--pred", pred])
    assert [r["frames"] for r in records if r["class"] == "veh"] == [
        len(val_ids)]
    return out0


def test_chain_train_resume_validate_test_bin_ap(files, tmp_path):
    _chain(files["recipe"], files["data"],
           [r["rec_id"] for r in files["val"]], tmp_path)


def test_chain_from_raw_frames_through_the_builder(files, tmp_path,
                                                   monkeypatch):
    """The chain above from raw frames: 2 training segments of 2 frames
    and a validation segment of 3 (``chip_smoke.waymo_frames`` at the tiny
    recipe's 16x128, a yawed roof-mounted lidar) as TFRecord files of
    serialized Frame protos, through the port's builder CLI on the CPU.
    The files are read by tests/torch_frames.py's TFRecord reader in
    TensorFlow's place (test_torch_builders.py reads them with
    TensorFlow)."""
    import chip_smoke as cs
    from fake_waymo_protos import install
    from rangedet_tpu_torch.tools import create_range_image_roidb as cli
    from torch_frames import (
        frame_proto,
        install_frame_utils,
        install_tfrecord_reader,
        write_tfrecord,
    )

    Frame = install(monkeypatch)["Frame"]
    install_tfrecord_reader(monkeypatch)
    ris, raw = {}, tmp_path / "raw"
    for split, segs in (("training", (2, 2)), ("validation", (3,))):
        (raw / split).mkdir(parents=True)
        for s, n in enumerate(segs):
            frames, parse, _ = cs.waymo_frames(
                torch, 10 * len(ris) + s, n, H, W, cs.BUILD_YAW,
                cs.BUILD_MOUNT, f"{split}_{s}", torch.device("cpu"),
                num_boxes=3)
            blobs = []
            for frame in frames:
                ts = len(ris)
                ris[ts] = parse(frame)[1][0]
                blobs.append(frame_proto(Frame, frame, ts))
            write_tfrecord(str(raw / split / f"segment-{s}.tfrecord"),
                           blobs)
    install_frame_utils(monkeypatch, ris)
    data = str(tmp_path / "built")
    for split in ("training", "validation"):
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main(["--tfrecord-dir", str(raw / split), "--out-dir", data,
                      "--split", split, "--workers", "2", "--device",
                      "cpu"])
    out0 = _chain(files["recipe"], data,
                  [f"segment-0_{i}" for i in range(3)], tmp_path)
    assert "params: 0." in out0  # tools/train.py's line, the tiny recipe


# ---------------------------------------------------------------- prefetch
def test_threaded_device_prefetch_puts_in_its_thread_in_order():
    from rangedet_tpu_torch.data.prefetch import threaded_device_prefetch

    before = set(threading.enumerate())
    main, threads, closed = threading.get_ident(), [], []

    def put(x):
        threads.append(threading.get_ident())
        return {"x": torch.full((2,), float(x))}

    def source():
        try:
            yield from range(10)
        finally:
            closed.append(True)

    out = [int(b["x"][0]) for b in threaded_device_prefetch(
        source(), put, depth=2, device=torch.device("cpu"))]
    assert out == list(range(10)) and closed == [True]
    assert len(threads) == 10 and main not in threads
    gen = threaded_device_prefetch(source(), put, depth=2)
    assert int(next(gen)["x"][0]) == 0
    gen.close()  # closes the source and joins the thread
    assert closed == [True, True]
    assert not set(threading.enumerate()) - before


def test_device_prefetch_order_depth_and_close():
    from rangedet_tpu.data.prefetch import device_prefetch as jax_prefetch
    from rangedet_tpu_torch.data.prefetch import device_prefetch

    items = list(range(10))
    for depth in (1, 2, 3):
        puts, seen = [], []

        def put(x):
            puts.append(x)
            return {"x": torch.full((2,), float(x))}

        for out in device_prefetch(iter(items), put, depth=depth,
                                   device=torch.device("cpu")):
            # put runs `depth` items ahead of the consumer
            assert len(puts) == min(len(seen) + depth, len(items))
            seen.append(int(out["x"][0]))
        assert seen == puts == items
        jax_puts = []
        assert list(jax_prefetch(iter(items), lambda x: jax_puts.append(x)
                                 or x, depth=depth)) == items == jax_puts

    closed = []

    def source():
        try:
            yield from items
        finally:
            closed.append(True)

    gen = device_prefetch(source(), lambda x: x, depth=2)
    assert next(gen) == 0
    gen.close()  # closes the source too (a loader epoch ends its workers)
    assert closed == [True]


def test_pool_map_prefetch_order_and_errors():
    from rangedet_tpu.data.prefetch import pool_map_prefetch as jax_pool
    from rangedet_tpu_torch.data.prefetch import pool_map_prefetch

    before = set(threading.enumerate())
    args = list(range(20))
    got = list(pool_map_prefetch(lambda a: a * a, iter(args), workers=3,
                                 depth=4))
    assert got == [a * a for a in args] == list(
        jax_pool(lambda a: a * a, iter(args), workers=3, depth=4))

    def boom(a):
        if a == 5:
            raise ValueError("boom")
        return a

    with pytest.raises(ValueError, match="boom"):
        list(pool_map_prefetch(boom, iter(args), workers=2, depth=3))
    assert not set(threading.enumerate()) - before  # the pool is joined


def test_param_count_is_jaxs(files):
    from rangedet_tpu.train.state import param_count as jax_count
    from rangedet_tpu_torch.train.state import param_count

    for recipe in ("rangedet_veh_wo_aug_4_18e", files["recipe"]):
        cfg = load_config(recipe, is_train=True)
        jcfg = (jax_load_config(recipe, is_train=True)
                if recipe.startswith("rangedet_") else tiny_config())
        # the parameters do not depend on the frame size: trace the
        # recipe's widths on the tiny frame
        jcfg = jcfg.replace(feat_size=(H, W), pad_field=(H, W))
        x = jnp.zeros((1, H, W, 8), jnp.float32)
        variables = jax.eval_shape(
            lambda: JaxRangeDet(**jcfg.model_kwargs()).init(
                jax.random.PRNGKey(0), x, x[..., :3], True))
        state = create_train_state(RangeDet(**cfg.model_kwargs()), cfg, 10)
        n = param_count(state)
        assert n == jax_count(types.SimpleNamespace(
            params=variables["params"])) > 0
