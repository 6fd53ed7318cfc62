"""Prediction pickle -> Waymo metrics .bin (or JSON), counterpart of
``tools/create_prediction_bin_3d.py``, around ``eval/waymo_bin.py``:

    python -m rangedet_tpu_torch.tools.create_prediction_bin_3d \
        --pred predictions_torch.pkl --out pred.bin   # needs waymo_open_dataset
    python -m rangedet_tpu_torch.tools.create_prediction_bin_3d \
        --pred predictions_torch.pkl --out pred.json  # no dependency
"""
from __future__ import annotations

import argparse


def main(argv=None) -> int:
    """Returns the number of objects written."""
    from rangedet_tpu_torch.eval.waymo_bin import export_bin, export_json

    p = argparse.ArgumentParser(description="Export a prediction pickle")
    p.add_argument("--pred", required=True,
                   help="prediction pickle from rangedet_tpu_torch.tools.test")
    p.add_argument("--out", required=True, help="output .bin (or .json) path")
    args = p.parse_args(argv)
    if args.out.endswith(".json"):
        n = export_json(args.pred, args.out)
    else:
        n = export_bin(args.pred, args.out)
    print(f"wrote {n} objects to {args.out}")
    return n


if __name__ == "__main__":
    main()
