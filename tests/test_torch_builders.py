"""The port's offline dataset builders (data/waymo_builder.py, data/kitti.py
and their CLIs) against the JAX package's, on the CPU with one torch
thread: the same seeded frames and scans through both.

Waymo frames come from ``chip_smoke.waymo_frames``: vehicles placed in the
vehicle frame and raytraced in the sensor frame of a yawed, roof-mounted
lidar in Waymo's column convention (range_image_utils.
compute_range_image_polar: column i looks along vehicle-frame azimuth
pi - (i + 1/2) 2 pi / W, along that less the extrinsic's yaw in the sensor
frame). A builder that gets the convention right puts every rendered
pixel's point back inside the box it hit. The JAX builder adds the yaw:
at a yaw of 0.3 its points miss their boxes by metres (ROADMAP Queue 3),
the port subtracts it; at a yaw of 0 both agree.

pc_vehicle_frame differs from JAX's by at most PC_ULPS f32 ulps of the
point's largest coordinate (numpy's and torch's f32 cos / sin differ by
an ulp at some inclinations); the range image, inclination, azimuth and
roidb are bit-equal. The KITTI range image is bit-equal to JAX's on these
scans: no point lies where numpy's and torch's f32 atan2 put it on
different sides of a row or column boundary, and no pixel has two points
at its least range (the tie rule, where the port and JAX may differ, is
counted: TIES)."""
import os
import pickle

import numpy as np
import pytest
import torch

import chip_smoke as cs
from rangedet_tpu.data import kitti as jkitti
from rangedet_tpu.data import waymo_builder as jwb
from rangedet_tpu_torch.data import kitti
from rangedet_tpu_torch.data import waymo_builder as wb

# one intra-op thread per test process: several workers share the cores
torch.set_num_threads(1)

CPU = torch.device("cpu")
H, W = 16, 256
PC_ULPS = 2
BOX_TOL = 0.01  # m, chip_smoke.BOX_TOL
KITTI_N = 20000
TIES = 0  # pixels of the scans below with two points at the least range

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _build(frames, parse, root, fn, **kw):
    return fn(iter(frames), parse, str(root), "training", "seg", **kw)


def _same_roidb(a, b):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert sorted(ra) == sorted(rb)
        for k in ra:
            if k in ("rec_id", "meta_info"):
                assert ra[k] == rb[k], k
            elif k != "pc_url":
                assert ra[k].dtype == rb[k].dtype, k
                np.testing.assert_array_equal(ra[k], rb[k], err_msg=k)


def _ulps(a, b):
    return float((np.abs(a - b)
                  / np.spacing(np.abs(b).max(-1, keepdims=True))).max())


@pytest.mark.parametrize("theta", [0.0, 0.3])
def test_waymo_builder_body_and_the_azimuth_sign(theta, tmp_path):
    frames, parse, owners = cs.waymo_frames(
        torch, 3, 2, H, W, theta, cs.BUILD_MOUNT, "seg", CPU, num_boxes=4)
    port = _build(frames, parse, tmp_path / "port",
                  wb.build_segment_from_frames, device="cpu")
    ref = _build(frames, parse, tmp_path / "jax",
                 jwb.build_segment_from_frames)
    _same_roidb(port, ref)
    with open(tmp_path / "port" / "training" / "seg.roidb", "rb") as f:
        _same_roidb(pickle.load(f), port)
    for i, (a, b) in enumerate(zip(port, ref)):
        na, nb = np.load(a["pc_url"]), np.load(b["pc_url"])
        for k in ("range_image", "inclination"):
            np.testing.assert_array_equal(na[k], nb[k], err_msg=k)
        owner, csa = owners[i]
        # first principles: each rendered pixel's point is in its box
        inside, n = cs.box_excess(na["pc_vehicle_frame"], owner, csa)
        missed, _ = cs.box_excess(nb["pc_vehicle_frame"], owner, csa)
        assert n > 50 and inside <= BOX_TOL
        if theta == 0.0:
            np.testing.assert_array_equal(na["azimuth"], nb["azimuth"])
            assert _ulps(na["pc_vehicle_frame"], nb["pc_vehicle_frame"]) \
                <= PC_ULPS
            assert missed <= BOX_TOL
        else:  # the JAX builder turns the points by 2 theta
            assert missed > 1.0
    # the difference is the sign of the yaw alone: the port's table at the
    # extrinsic's yaw is JAX's at minus that yaw, bit for bit
    ext = cs.lidar_extrinsic(theta, cs.BUILD_MOUNT)
    yaw = float(np.arctan2(ext[1, 0], ext[0, 0]))
    np.testing.assert_array_equal(wb.azimuth_table(W, yaw, "cpu").numpy(),
                                  jwb.azimuth_table(W, -yaw))
    np.testing.assert_array_equal(
        np.load(port[0]["pc_url"])["azimuth"],
        jwb.azimuth_table(W, -yaw).astype(np.float32))


def test_waymo_builder_geometry_and_roidb_against_jax(rng):
    # spherical_to_cartesian at JAX's precision on one table
    r = rng.uniform(-1, 70, (H, W)).astype(np.float32)
    incl = np.linspace(0.03, -0.3, H).astype(np.float32)
    az = jwb.azimuth_table(W, 0.0)
    got = wb.spherical_to_cartesian(
        torch.from_numpy(r), torch.from_numpy(incl),
        torch.from_numpy(az)).numpy()
    want = jwb.spherical_to_cartesian(r, incl, az)
    assert got.dtype == want.dtype == np.float32
    assert _ulps(got, want) <= PC_ULPS
    boxes = np.array([[10, 2, 1, 4, 2, 1.6, 0.3], [-5, 7, 0.5, 4.5, 1.9,
                                                    1.5, -1.2]], np.float32)
    np.testing.assert_array_equal(wb.corners_from_csa(boxes),
                                  jwb.corners_from_csa(boxes))
    rec = dict(frame_id="f", npz_path="p.npz", gt_csa=boxes,
               gt_class=np.ones(2), points_in_box=np.array([3, 4]),
               meta={"name": "s"}, motion=np.arange(8.0).reshape(2, 4))
    _same_roidb([wb.build_frame_record(**rec)],
                [jwb.build_frame_record(**rec)])


def test_builder_cli_against_jax_cli_on_tfrecords(tmp_path, monkeypatch):
    """The port's CLI and tools/create_range_image_roidb.py on the same
    .tfrecord segments, read by TensorFlow's tf.data (only the Waymo
    wheel's protos are mirrored, by tests/fake_waymo_protos.py). The files
    are written by tests/torch_frames.py, whose format TensorFlow checks
    here (its CRCs) for the tests that read them without TensorFlow."""
    pytest.importorskip("tensorflow")
    from fake_waymo_protos import install
    from torch_frames import frame_proto, install_frame_utils, write_tfrecord

    Frame = install(monkeypatch)["Frame"]
    frames, parse, _ = cs.waymo_frames(torch, 5, 4, H, W, 0.0,
                                       cs.BUILD_MOUNT, "seg", CPU,
                                       num_boxes=3)
    ris = {}
    tf_dir = tmp_path / "tfrecords"
    tf_dir.mkdir()
    for seg in range(2):
        blobs = []
        for i in range(2):
            ts = 10 * seg + i
            ris[ts] = parse(frames[2 * seg + i])[1][0]
            blobs.append(frame_proto(Frame, frames[2 * seg + i], ts))
        write_tfrecord(str(tf_dir / f"segment-{seg}.tfrecord"), blobs)
    install_frame_utils(monkeypatch, ris)
    monkeypatch.syspath_prepend(os.path.join(REPO, "tools"))
    import create_range_image_roidb as jcli

    from rangedet_tpu_torch.data.waymo import load_roidbs, record_to_inputs
    from rangedet_tpu_torch.tools import create_range_image_roidb as cli

    common = ["--tfrecord-dir", str(tf_dir), "--split", "training",
              "--workers", "2"]
    cli.main(common + ["--out-dir", str(tmp_path / "port"), "--device",
                       "cpu"])
    jcli.main(common + ["--out-dir", str(tmp_path / "jax")])
    for seg in range(2):
        name = f"segment-{seg}.roidb"
        with open(tmp_path / "port" / "training" / name, "rb") as f:
            port = pickle.load(f)
        with open(tmp_path / "jax" / "training" / name, "rb") as f:
            ref = pickle.load(f)
        _same_roidb(port, ref)
        for a, b in zip(port, ref):
            na, nb = np.load(a["pc_url"]), np.load(b["pc_url"])
            for k in ("range_image", "inclination", "azimuth"):
                np.testing.assert_array_equal(na[k], nb[k], err_msg=k)
            assert _ulps(na["pc_vehicle_frame"], nb["pc_vehicle_frame"]) \
                <= PC_ULPS
    roidb = load_roidbs(str(tmp_path / "port"), ("training",))
    assert len(roidb) == 4
    b = record_to_inputs(roidb[0], (H, W), 8)
    assert np.isfinite(b["input_data"]).all() and b["gt_valid"].sum() == 3


# ---------------------------------------------------------------- KITTI
def _oracle_range_image(pc, width):
    """tests/test_kitti.py's direct transcription of the reference."""
    from test_kitti import _oracle_range_image as oracle

    return oracle(pc, jkitti.KITTI_INCLINATION, jkitti.KITTI_LASER_HEIGHT,
                  width)


@pytest.fixture(scope="module")
def kitti_data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("kitti"))
    scans, boxes = cs.kitti_root(root, 7, 2, KITTI_N)
    return root, scans, boxes


def test_kitti_range_image_against_jax_and_the_oracle(kitti_data):
    _, scans, _ = kitti_data
    for width in (2048, 512):
        for scan in scans:
            got = kitti.build_range_image(scan, width, device="cpu").numpy()
            np.testing.assert_array_equal(
                got, jkitti.build_range_image(scan, width=width))
            np.testing.assert_array_equal(
                got, _oracle_range_image(scan, width))
    assert sum(kitti.range_image_ties(s, device="cpu") for s in scans) \
        == TIES


def test_kitti_nearest_point_wins_and_the_tie_rule():
    base = np.array([[12.0, 3.0, -0.5, 0.25]], np.float32)
    far = base.copy()
    far[:, :3] *= 1.01
    far[:, 3] = 0.75
    row, col, _ = kitti.pixel_indices(torch.from_numpy(
        np.concatenate([base, far])))
    assert row[0] == row[1] and col[0] == col[1]  # one pixel
    for pc in (np.concatenate([far, base]), np.concatenate([base, far])):
        img = kitti.build_range_image(pc, device="cpu").numpy()
        filled = img[img[..., 0] > -1]
        assert len(filled) == 1 and filled[0, 4] == 0.25
        np.testing.assert_array_equal(img, jkitti.build_range_image(pc))
    # two points at the same range on one pixel: the last of the scan
    twin = base.copy()
    twin[:, 3] = 0.5
    img = kitti.build_range_image(np.concatenate([base, twin, far]),
                                  device="cpu").numpy()
    assert img[img[..., 0] > -1][0, 4] == 0.5
    assert kitti.range_image_ties(np.concatenate([base, twin]),
                                  device="cpu") == 1


def test_kitti_calibration_boxes_counts_and_inputs(kitti_data, rng):
    root, scans, boxes = kitti_data
    calib_file = os.path.join(root, "calib", "000000.txt")
    cal, jcal = kitti.Calibration(calib_file), jkitti.Calibration(calib_file)
    for k in ("P2", "R0", "V2C"):
        np.testing.assert_array_equal(getattr(cal, k), getattr(jcal, k))
    pts = rng.uniform(-20, 20, (50, 3)).astype(np.float32)
    np.testing.assert_array_equal(cal.rect_to_lidar(pts),
                                  jcal.rect_to_lidar(pts))
    np.testing.assert_array_equal(cal.lidar_to_rect(pts),
                                  jcal.lidar_to_rect(pts))
    cam = np.array([[1.0, 1.6, 12.0, 4.2, 1.5, 1.8, 0.4],
                    [-3.0, 1.7, 25.0, 3.9, 1.6, 1.7, -2.0]], np.float32)
    np.testing.assert_array_equal(
        kitti.boxes_camera_to_lidar_csa(cam, cal),
        jkitti.boxes_camera_to_lidar_csa(cam, jcal))
    for scan, csa in zip(scans, boxes):
        got = kitti.points_in_boxes_csa(scan[:, :3], csa, device="cpu")
        want = jkitti.points_in_boxes_csa(scan[:, :3], csa)
        assert got.dtype == np.float32
        # counts may differ by the points within FACE_BAND of a face
        faces = cs.face_points(scan, csa).sum(1)
        assert (np.abs(got - want) <= faces).all()
        assert (got >= cs.KITTI_BOX_POINTS).all()
    assert kitti.points_in_boxes_csa(scans[0][:, :3], np.zeros((0, 7)),
                                     device="cpu").shape == (0,)
    got = kitti.kitti_frame_to_inputs(scans[0], (64, 2056), 8, boxes[0],
                                      np.ones(3), device="cpu")
    want = jkitti.kitti_frame_to_inputs(scans[0], (64, 2056), 8, boxes[0],
                                        np.ones(3))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_kitti_cli_against_jax_cli(kitti_data, tmp_path, monkeypatch):
    root, scans, boxes = kitti_data
    monkeypatch.syspath_prepend(os.path.join(REPO, "tools"))
    import create_range_image_in_kitti as jcli

    from rangedet_tpu_torch.data.waymo import load_roidbs, record_to_inputs
    from rangedet_tpu_torch.tools import create_range_image_in_kitti as cli

    common = ["--kitti-root", root, "--split", "train", "--width", "512"]
    roidb = cli.main(common + ["--out-dir", str(tmp_path / "port"),
                               "--device", "cpu"])
    jcli.main(common + ["--out-dir", str(tmp_path / "jax")])
    with open(tmp_path / "jax" / "train" / "kitti.roidb", "rb") as f:
        ref = pickle.load(f)
    with open(tmp_path / "port" / "train" / "kitti.roidb", "rb") as f:
        _same_roidb(pickle.load(f), roidb)
    assert len(roidb) == len(scans) == len(ref)
    for a, b, scan, csa in zip(roidb, ref, scans, boxes):
        for k in a:
            if k == "points_in_box":  # a count may flip at a face
                assert (np.abs(a[k] - b[k])
                        <= cs.face_points(scan, csa).sum(1)).all()
            elif k in ("rec_id", "meta_info"):
                assert a[k] == b[k]
            elif k != "pc_url":
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        np.testing.assert_allclose(a["gt_bbox_csa"], csa, atol=1e-5)
        na, nb = np.load(a["pc_url"]), np.load(b["pc_url"])
        assert sorted(na.files) == sorted(nb.files)
        for k in na.files:
            np.testing.assert_array_equal(na[k], nb[k], err_msg=k)
    entry = record_to_inputs(load_roidbs(str(tmp_path / "port"),
                                         ("train",))[0], (64, 520), 8)
    assert entry["input_data"].shape == (64, 520, 8)
    assert np.isfinite(entry["input_data"]).all()
    assert entry["gt_valid"].sum() == len(boxes[0])
    assert (entry["is_in_nlz"] <= 0).all()


def test_builders_need_the_card_unless_asked_for_the_cpu(kitti_data):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    _, scans, boxes = kitti_data
    frames, parse, _ = cs.waymo_frames(torch, 1, 1, 4, 32, 0.0,
                                       cs.BUILD_MOUNT, "seg", CPU,
                                       num_boxes=1)
    calls = (
        lambda: wb.azimuth_table(32),
        lambda: wb.build_segment_from_frames(iter(frames), parse,
                                             "/nonexistent", "x", "seg"),
        lambda: kitti.build_range_image(scans[0]),
        lambda: kitti.points_in_boxes_csa(scans[0][:, :3], boxes[0]),
    )
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA card"):
            call()
