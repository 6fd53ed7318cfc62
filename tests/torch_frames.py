"""Waymo frames as the builders read them, for the tests of the port's
builder CLI: the duck-typed frames of ``chip_smoke.waymo_frames`` as
serialized Frame protos (the mirror of tests/fake_waymo_protos.py),
TFRecord files of them, and stand-ins for the two modules the builder
imports besides the protos: ``waymo_open_dataset.utils.frame_utils``
(the range image of a frame, by its timestamp) and, where TensorFlow's
import (~15 s) does not fit a test's budget, a ``tensorflow`` whose
``data.TFRecordDataset`` reads the TFRecord format (length, masked CRC32C
of it, payload, masked CRC32C of that) and checks both CRCs."""
import struct
import sys
import types

_CASTAGNOLI = []
for _n in range(256):
    _c = _n
    for _ in range(8):
        _c = (_c >> 1) ^ (0x82F63B78 if _c & 1 else 0)
    _CASTAGNOLI.append(_c)


def masked_crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CASTAGNOLI[(crc ^ b) & 0xFF] ^ (crc >> 8)
    crc ^= 0xFFFFFFFF
    return ((((crc >> 15) | (crc << 17)) & 0xFFFFFFFF) + 0xA282EAD8) \
        & 0xFFFFFFFF


def write_tfrecord(path, records):
    with open(path, "wb") as f:
        for r in records:
            head = struct.pack("<Q", len(r))
            f.write(head + struct.pack("<I", masked_crc32c(head)) + r
                    + struct.pack("<I", masked_crc32c(r)))


def read_tfrecord(path):
    with open(path, "rb") as f:
        data = f.read()
    i = 0
    while i < len(data):
        head = data[i:i + 8]
        (n,) = struct.unpack("<Q", head)
        assert struct.unpack("<I", data[i + 8:i + 12])[0] == \
            masked_crc32c(head), path
        r = data[i + 12:i + 12 + n]
        assert struct.unpack("<I", data[i + 12 + n:i + 16 + n])[0] == \
            masked_crc32c(r), path
        yield r
        i += 16 + n


def frame_proto(Frame, frame, ts):
    """A duck-typed frame -> serialized Frame proto, timestamp ``ts``."""
    f = Frame()
    f.context.name = frame.context.name
    f.timestamp_micros = ts
    src = frame.context.laser_calibrations[0]
    cal = f.context.laser_calibrations.add()
    cal.name = src.name
    cal.beam_inclinations.extend(src.beam_inclinations)
    cal.extrinsic.transform.extend(src.extrinsic.transform)
    for lab in frame.laser_labels:
        out = f.laser_labels.add()
        for k in ("center_x", "center_y", "center_z", "length", "width",
                  "height", "heading"):
            setattr(out.box, k, getattr(lab.box, k))
        out.type = lab.type
        out.num_lidar_points_in_box = lab.num_lidar_points_in_box
        for k in ("speed_x", "speed_y", "accel_x", "accel_y"):
            setattr(out.metadata, k, getattr(lab.metadata, k))
    return f.SerializeToString()


def install_frame_utils(monkeypatch, range_images):
    """frame_utils.parse_range_image_and_camera_projection: the TOP
    lidar's range image ``range_images[frame.timestamp_micros]``."""
    fu = types.ModuleType("waymo_open_dataset.utils.frame_utils")
    fu.parse_range_image_and_camera_projection = lambda frame: (
        {1: [range_images[frame.timestamp_micros]]}, None, None, None)
    utils = types.ModuleType("waymo_open_dataset.utils")
    utils.frame_utils = fu
    monkeypatch.setitem(sys.modules, "waymo_open_dataset.utils", utils)
    monkeypatch.setitem(sys.modules, "waymo_open_dataset.utils.frame_utils",
                        fu)


class _Record:
    def __init__(self, b):
        self._b = b

    def numpy(self):
        return self._b


def install_tfrecord_reader(monkeypatch):
    tf = types.ModuleType("tensorflow")
    tf.data = types.SimpleNamespace(
        TFRecordDataset=lambda path, compression_type="": (
            _Record(r) for r in read_tfrecord(path)))
    monkeypatch.setitem(sys.modules, "tensorflow", tf)
