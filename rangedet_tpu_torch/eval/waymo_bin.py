"""Prediction pickle → official Waymo ``metrics_pb2.Objects`` ``.bin`` export,
preserving the reference output format (tools/create_prediction_bin_3d.py):
the port's copy of ``rangedet_tpu/eval/waymo_bin.py``.

``waymo_open_dataset`` is not baked into this image, so the proto path is
gated: with the package installed this produces byte-identical submissions;
without it, ``export_json`` writes the same content as JSON for inspection.
"""
from __future__ import annotations

import json
import pickle

TYPE_BY_NAME = {"veh": 1, "ped": 2, "cyc": 4, "sign": 3, "unknown": 0}


def load_prediction_pickle(path: str):
    """Read the two-dump pickle written by tools/test.py (and the reference's
    tools/test.py:235-238): (annotation_dict, output_dict)."""
    with open(path, "rb") as f:
        annotation_dict = pickle.load(f)
        output_dict = pickle.load(f)
    return annotation_dict, output_dict


def export_bin(pred_pickle_path: str, out_bin_path: str) -> int:
    """Write metrics_pb2.Objects; mirrors _create_bbox_prediction + main
    (create_prediction_bin_3d.py:26-97). Returns #objects written."""
    try:
        from waymo_open_dataset.protos import metrics_pb2
        from waymo_open_dataset import label_pb2  # noqa: F401
    except ImportError as e:  # pragma: no cover - env without waymo deps
        raise ImportError(
            "waymo_open_dataset is required for .bin export; use export_json "
            "for a dependency-free dump"
        ) from e

    _, output_dict = load_prediction_pickle(pred_pickle_path)
    objects = metrics_pb2.Objects()
    count = 0
    for rec_id, output in output_dict.items():
        if not output:
            continue
        meta = output["meta_info"]
        for pred_type, boxes in output["det_xyzlwhyaws"].items():
            for b in boxes:
                o = metrics_pb2.Object()
                o.context_name = str(meta["name"])
                o.frame_timestamp_micros = int(meta["timestamp_micros"])
                o.object.box.center_x = float(b[0])
                o.object.box.center_y = float(b[1])
                o.object.box.center_z = float(b[2])
                o.object.box.length = float(b[3])
                o.object.box.width = float(b[4])
                o.object.box.height = float(b[5])
                o.object.box.heading = float(b[6])
                if len(b) == 8:
                    o.score = float(b[7])
                o.object.id = ""
                o.object.type = TYPE_BY_NAME[pred_type]
                objects.objects.append(o)
                count += 1
    with open(out_bin_path, "wb") as f:
        f.write(objects.SerializeToString())
    return count


def export_json(pred_pickle_path: str, out_json_path: str) -> int:
    """Dependency-free export of the same content (for offline inspection)."""
    _, output_dict = load_prediction_pickle(pred_pickle_path)
    rows = []
    for rec_id, output in output_dict.items():
        if not output:
            continue
        meta = output["meta_info"]
        for pred_type, boxes in output["det_xyzlwhyaws"].items():
            for b in boxes:
                rows.append(
                    dict(
                        context_name=str(meta["name"]),
                        frame_timestamp_micros=int(meta["timestamp_micros"]),
                        box=[float(x) for x in b[:7]],
                        score=float(b[7]) if len(b) == 8 else None,
                        type=TYPE_BY_NAME[pred_type],
                    )
                )
    with open(out_json_path, "w") as f:
        json.dump(rows, f)
    return len(rows)
