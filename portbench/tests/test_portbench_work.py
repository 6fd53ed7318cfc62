"""The work counts against the program's own arithmetic: veh's forward
FLOPs against ``tools/flops.py``'s 1092.0 GFLOP a frame, tpuopt's from its
widths, and the Meta-Kernel bounds against ``tools/profile_meta.py``."""
import json

import pytest

from portbench import run, work

H = 64


def _config(name):
    return json.loads((run.ROOT / "portbench" / "configs"
                       / f"{name}.json").read_text())["config"]


def strided_conv1_excess(c):
    """FLOPs by which a strided stage's unit-1 conv1, which runs at the
    stage's input width (conv2 carries the stride), exceeds the same conv
    at the output width, where ``tools/flops.py`` counts it."""
    ch, wd = work._widths(c)
    return sum(2 * H * (wd[src] - wd[name]) * ch[src] * ch[name] * 9
               for name, src, s in work.STAGES if s > 1)


def flops_py_parts(c):
    """``tools/flops.py:parts`` with the widths taken from ``c``."""
    nf, nb = c["num_filter"], c["num_block"]
    cm, cc = c["meta_units"]["res1_unit2"]["channel_list"]

    def conv3(w, ci, co):
        return 2 * H * w * ci * co * 9

    def block(w, ci, co, proj):
        return conv3(w, ci, co) + conv3(w, co, co) + (
            2 * H * w * ci * co if proj else 0)

    def stage(w, ci, co, n):
        return block(w, ci, co, True) + (n - 1) * block(w, co, co, False)

    def deconv(w, ci, co, kw):
        return 2 * H * w * ci * co * 3 * kw

    f = (block(2656, 8, nf["res1"], True)
         + 2 * 9 * H * 2656 * (3 * cm + cm * cc)
         + 2 * H * 2656 * 9 * cc * nf["res1"] + conv3(2656, nf["res1"],
                                                     nf["res1"]))
    f += stage(1328, nf["res1"], nf["res2a"], nb["res2a"])
    f += stage(664, nf["res2a"], nf["res2"], nb["res2"])
    f += stage(332, nf["res2"], nf["res3a"], nb["res3a"])
    f += stage(166, nf["res3a"], nf["res3"], nb["res3"])
    f += deconv(166, nf["res3"], nf["agg2"], 8) + stage(
        664, nf["agg2"], nf["agg2"], nb["agg2"])
    f += deconv(664, nf["res2"], nf["agg1"], 8) + stage(
        2656, nf["agg1"], nf["agg1"], nb["agg1"])
    f += deconv(664, nf["agg2"], nf["agg2a"], 4) + stage(
        1328, nf["agg2a"], nf["agg2a"], nb["agg2a"])
    f += deconv(1328, nf["agg2a"], nf["agg3"], 4) + stage(
        2656, nf["agg3"], nf["agg3"], nb["agg3"])
    for w, ci in ((2656, nf["agg3"] + 8), (1328, nf["agg2a"]),
                  (664, nf["agg2"])):
        f += 2 * (conv3(w, ci, 128) + 3 * conv3(w, 128, 128))
        f += 2 * H * w * 128 * 9
    return f


def test_veh_forward_matches_tools_flops():
    from rangedet_tpu_torch.tools import flops

    c = _config("rangedet_veh_wo_aug_4_18e")
    total = work.forward_flops(c)
    assert flops_py_parts(c) == sum(flops.parts().values())
    assert round((total - strided_conv1_excess(c)) / 1e9, 1) == \
        flops.totals()["fwd_gflop_per_frame"] == 1092.0
    assert work.train_flops(c) == 3 * total


def test_tpuopt_forward_follows_its_widths():
    c = _config("rangedet_veh_tpuopt_all_36e")
    veh = _config("rangedet_veh_wo_aug_4_18e")
    total = work.forward_flops(c)
    assert total == flops_py_parts(c) + strided_conv1_excess(c)
    # the wider recipe: every backbone width doubled, the head's kept
    assert 2.2 < total / work.forward_flops(veh) < 2.5
    assert len(list(work.convs(c))) == len(list(work.convs(veh))) == 73


@pytest.mark.parametrize("name", ["rangedet_veh_wo_aug_4_18e",
                                  "rangedet_veh_tpuopt_all_36e"])
def test_meta_bounds_match_profile_meta(name):
    from rangedet_tpu_torch.tools import profile_meta

    c = _config(name)
    cm, cc = c["meta_units"]["res1_unit2"]["channel_list"]
    co = c["num_filter"]["res1"]
    want = sum(profile_meta.tc_bound_ms(k, 2, H, 2656, cc, cm, co)[0]
               for k in ("stats", "agg", "bwd_agg", "bwd_stats")) / 1e3
    assert work.meta_block_bound_s(c, 2) == pytest.approx(want, rel=1e-12)
    taps = profile_meta.tc_bound_ms("taps", 4, H, 2656, cc, cm, co)[0] / 1e3
    assert work.meta_taps_bound_s(c, 4) == pytest.approx(taps, rel=1e-12)


def test_conv_bounds_are_the_operations():
    """At these widths every conv is bound by its operations: the step's
    bound is its FLOPs at the bf16 peak, the data gradient of the first
    conv left out."""
    c = _config("rangedet_veh_wo_aug_4_18e")
    first = next(work.convs(c))
    assert first[4]  # the first conv reads the data
    fwd = 2 * sum(2 * H * wo * 9 * ci * co for ci, co, _, wo, _ in
                  work.convs(c))
    fwd += 2 * sum(2 * H * w * 3 * kw * ci * co for ci, co, w, kw, _ in
                   work.deconvs(c))
    assert work.conv3x3_bound_s(c, 2, False) == pytest.approx(
        fwd / work.PEAK_BF16, rel=0.02)
    assert 2.9 * work.conv3x3_bound_s(c, 2, False) < \
        work.conv3x3_bound_s(c, 2, True) < 3 * work.conv3x3_bound_s(
            c, 2, False)
