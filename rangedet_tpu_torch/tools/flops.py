"""Analytic FLOP count of ``rangedet_veh_wo_aug_4_18e`` at 64x2656, the
port's copy of ``tools/flops.py`` (the port imports nothing of the JAX
package), for MFU accounting on the card:

    python -m rangedet_tpu_torch.tools.flops

Counts the contractions (convs, matmuls, 2 * MACs) layer by layer from the
architecture ``models/dla_backbone.py`` + ``models/head.py`` build (the
reference's stage / agg wiring and head towers). Elementwise work (BN,
relu, losses, targets) is excluded, so an MFU from this count is an
underestimate. Prints one line per part (GFLOP a frame) and then one JSON
line: fwd_gflop_per_frame and fwd_bwd_gflop_per_frame (dgrad and wgrad
each cost one forward).
"""
import json

H = 64


def conv3(w_out, ci, co, taps=9):
    return 2 * H * w_out * ci * co * taps


def deconv(w_in, ci, co, kw):
    # transposed conv k=(3,kw): every input pixel contributes 3*kw taps
    return 2 * H * w_in * ci * co * 3 * kw


def block(w, ci, co, proj):
    f = conv3(w, ci, co) + conv3(w, co, co)
    if proj:
        f += 2 * H * w * ci * co  # 1x1 shortcut
    return f


def stage(w, ci, co, nb):
    f = block(w, ci, co, True)
    for _ in range(nb - 1):
        f += block(w, co, co, False)
    return f


def meta_block(w, c, mid):
    mlp = 2 * 9 * H * w * (3 * mid + mid * c)  # shared MLP over 9 taps
    agg = 2 * H * w * (9 * c) * c  # 1x1 aggregation of the 9C tensor
    return mlp + agg


def parts():
    """{part: forward FLOPs a frame}, in the model's order."""
    out = {}
    # backbone (widths: stride-2 in W at res2a / res2 / res3a / res3)
    out["res1"] = (
        block(2656, 8, 64, True)
        # unit2 = meta block (replaces conv1) + conv2
        + meta_block(2656, 64, 32) + conv3(2656, 64, 64)
    )
    out["res2a"] = stage(1328, 64, 64, 3)
    out["res2"] = stage(664, 64, 128, 3)
    out["res3a"] = stage(332, 128, 128, 5)
    out["res3"] = stage(166, 128, 128, 5)
    out["agg2"] = deconv(166, 128, 128, 8) + stage(664, 128, 128, 2)
    out["agg1"] = deconv(664, 128, 64, 8) + stage(2656, 64, 64, 2)
    out["agg2a"] = deconv(664, 128, 64, 4) + stage(1328, 64, 64, 1)
    out["agg3"] = deconv(1328, 64, 64, 4) + stage(2656, 64, 64, 2)

    # head: per-level cls + reg towers (4 x 3x3 @128) + 1x1 projections
    head = 0
    for w, ci in ((2656, 72), (1328, 64), (664, 128)):
        for _ in range(2):  # cls and reg towers
            head += conv3(w, ci, 128) + 3 * conv3(w, 128, 128)
        head += 2 * H * w * 128 * (1 + 8)  # logit + delta 1x1
    out["head"] = head
    return out


def totals(p=None):
    """The JSON line's numbers: forward and forward+backward GFLOP a
    frame, rounded to 0.1 as ``tools/flops.py`` prints them."""
    total_fwd = sum((p or parts()).values())
    return {
        "fwd_gflop_per_frame": round(total_fwd / 1e9, 1),
        # dgrad + wgrad each cost one forward; elementwise excluded
        "fwd_bwd_gflop_per_frame": round(3 * total_fwd / 1e9, 1),
    }


def main():
    p = parts()
    for k, v in p.items():
        print(f"{k:8s} {v / 1e9:8.2f} GFLOP/frame")
    print(json.dumps(totals(p)))


if __name__ == "__main__":
    main()
