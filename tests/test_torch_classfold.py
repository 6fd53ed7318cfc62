"""The eval post-processing's class axis folded into its rows
(``models/detector.py:run_inference``): every class's boxes, validity and
truncation equal those of the classes run one after another (the loop
below, as the function ran before the fold) bit for bit, with one sort,
one decode and one weighted-NMS call a step; a class of fewer candidates
is padded (its weighted rows then within a bound, see the test) and a
class's keep cap is its own; against the benchmark's
plain reference at a tiny size; the profiler ranges once a step; and, on
a card, the same over ``multiclass.eval.b4``'s 8 batches at full size.

On the CPU torch's ``atan2`` (``ops/boxes.py:box10_to_box11``) takes
its vector path for every element but a scalar tail of fewer than 32 at
the end of an array (AVX-512), and the two round some elements apart, in
the loop as in the fold; so the CPU cases use sizes where every class's
B x candidates is a multiple of 32 and no element falls in a tail. The
card's kernels compute each element alike wherever it lies.
"""
from unittest import mock

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rangedet_tpu_torch.configs import load_config
from rangedet_tpu_torch.models import detector
from rangedet_tpu_torch.ops import boxes as ops_boxes
from rangedet_tpu_torch.ops import decode as ops_decode
from rangedet_tpu_torch.ops import nms

# one intra-op thread per test process: several workers share the cores
torch.set_num_threads(1)

MULTI = "rangedet_multiclass_all_36e"


def per_class_loop(cls_logits, reg_deltas, batch, cfg):
    """``run_inference`` with a loop over the classes, each its own
    mask, sort, gathers, decode and weighted-NMS call."""
    B = cls_logits[0].shape[0]
    K = cfg.num_classes
    scores = torch.cat(
        [torch.sigmoid(l).reshape(B, -1, K) for l in cls_logits], dim=1)
    deltas = torch.cat([d.reshape(B, -1, K, 8) for d in reg_deltas], dim=1)
    pc = torch.cat(
        [batch[f"pc_s{s}"].reshape(B, -1, 3) for s in cfg.fpn_strides], 1)
    mask = torch.cat(
        [batch[f"mask_s{s}"].reshape(B, -1) for s in cfg.fpn_strides], 1)
    results = {}
    for k, name in enumerate(cfg.class_names):
        topk = min(cfg.device_topk.get(name, 4096),
                   cfg.pre_nms_top_n.get(name, 50000), scores.shape[1])
        min_score = cfg.min_score[name]
        masked = torch.where(mask > 0, scores[..., k],
                             torch.zeros_like(scores[..., k]))
        idx = torch.sort(-masked, dim=1, stable=True).indices[:, :topk]
        top_scores = torch.gather(masked, 1, idx)
        top_deltas = torch.gather(deltas[:, :, k], 1,
                                  idx[..., None].expand(-1, -1, 8))
        top_pc = torch.gather(pc, 1, idx[..., None].expand(-1, -1, 3))
        valid = top_scores > min_score
        truncated = top_scores[:, -1] > min_score
        box11 = ops_boxes.box10_to_box11(
            ops_decode.decode_boxes(top_deltas, top_pc))
        out12, out_valid = nms.weighted_nms(
            box11, top_scores, valid, thresh=cfg.wnms_thr_lo,
            thresh_vote=cfg.wnms_thr_hi, max_keep=cfg.post_nms_top_n[name],
            iou_3d=cfg.wnms_is_3d, block=cfg.wnms_block)
        results[name] = {"boxes": ops_boxes.box12_to_box8_eval(out12),
                         "valid": out_valid, "truncated": truncated}
    return results


def _heads(cfg, B, H, W, seed, bias=1.0):
    """Seeded logits, deltas, points and masks of every level: (cls, reg,
    batch). ``bias`` lifts the logits, so most pixels clear min_score."""
    K = cfg.num_classes
    g = torch.Generator().manual_seed(seed)
    cls, reg, batch = [], [], {}
    for s in cfg.fpn_strides:
        w = W // s
        cls.append(torch.randn(B, H, w, K, generator=g) + bias)
        reg.append(torch.randn(B, H, w, 8 * K, generator=g) * 0.3)
        batch[f"pc_s{s}"] = torch.randn(B, H, w, 3, generator=g) * 20
        batch[f"mask_s{s}"] = (torch.rand(B, H, w, 1, generator=g)
                               > 0.2).float()
    return cls, reg, batch


def _count_calls():
    calls = []
    real = nms.weighted_nms

    def grab(*a, **kw):
        out = real(*a, **kw)
        calls.append((a, kw, out))
        return out

    return calls, mock.patch.object(nms, "weighted_nms", grab)


def _same_outputs(got, want):
    assert list(got) == list(want)
    for name in want:
        for key in ("boxes", "valid", "truncated"):
            a, b = got[name][key], want[name][key]
            assert a.shape == b.shape and torch.equal(a, b), (name, key)


def _gap_bound(dets, valid):
    """``tests/test_torch_wnms_plan.py:mean_gap_bound`` taken coarsely, a
    row's bound (F, 11) on how far two f32 weighted means of its voters
    may lie apart: m = its valid candidates, each |value| at most the
    column's largest over them."""
    u = 2.0 ** -24
    m = valid.sum(-1, keepdim=True).double()
    amax = torch.where(valid[..., None], dets.abs(),
                       torch.zeros_like(dets)).amax(1).double()
    return 2 * (2 * (m + 1) * u + u) * amax


def _close_rows(got, gv, want, wv, bound):
    """Rows (F, W, 12) alike: validity and the score column bit for bit,
    the 11 averaged values within ``bound`` (F, 11)."""
    assert got.shape == want.shape and torch.equal(gv, wv)
    assert torch.equal(got[..., 11], want[..., 11])
    gap = (got[..., :11] - want[..., :11]).abs().double()
    assert bool((gap <= bound[:, None]).all()), float(gap.max())


CASES = {
    # (recipe, B, device_topk, post_nms_top_n or None for the recipe's)
    "veh": ("rangedet_veh_wo_aug_4_18e", 2, {"veh": 256}, None),
    "three_classes": (MULTI, 2, {"veh": 256, "ped": 256, "cyc": 256}, None),
    # ped and cyc padded to veh's 256 candidates; ped keeps 40 boxes,
    # fewer than its frames' survivors
    "padded": (MULTI, 2, {"veh": 256, "ped": 96, "cyc": 160},
               {"veh": 200, "ped": 40, "cyc": 100}),
    "padded_b4": (MULTI, 4, {"veh": 64, "ped": 128, "cyc": 32},
                  {"veh": 30, "ped": 200, "cyc": 7}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_fold_equals_the_per_class_loop(case):
    """Where no class is padded, every output bit for bit; a padded class
    adds zero, invalid columns to its row, over which the plain route's
    f32 sums may run in another order: its validity, truncation and
    scores bit for bit, its weighted rows within ``_gap_bound``."""
    recipe, B, topk, keep = CASES[case]
    cfg = load_config(recipe, False).replace(device_topk=topk)
    if keep is not None:
        cfg = cfg.replace(post_nms_top_n=keep)
    cls, reg, batch = _heads(cfg, B, 8, 64, seed=len(case))
    loop_calls, patch = _count_calls()
    with patch:
        want = per_class_loop(cls, reg, batch, cfg)
    calls, patch = _count_calls()
    with patch:
        got = detector.run_inference(cls, reg, batch, cfg)
    (args, kw, (rows, row_valid)), = calls  # one call over B x K rows
    K = cfg.num_classes
    T = max(topk.values())
    assert tuple(args[0].shape) == (B * K, T, 11)
    caps = [cfg.post_nms_top_n[n] for n in cfg.class_names]
    assert kw["max_keep"] == (caps[0] if len(set(caps)) == 1 else caps)
    if len(set(topk.values())) == 1:
        _same_outputs(got, want)
    bound = _gap_bound(args[0], args[2]).reshape(B, K, 11)
    rows, row_valid = rows.reshape(B, K, -1, 12), row_valid.reshape(B, K, -1)
    for k, name in enumerate(cfg.class_names):
        for key in ("valid", "truncated"):
            assert torch.equal(got[name][key], want[name][key]), (name, key)
        assert torch.equal(got[name]["boxes"][..., 7],
                           want[name]["boxes"][..., 7]), name
        cap = caps[k]
        _close_rows(rows[:, k, :cap], row_valid[:, k, :cap],
                    *loop_calls[k][2], bound[:, k])
        valid = want[name]["valid"]
        # the caps bind: every class keeps boxes, the small caps fill up
        assert int(valid.sum()) > 0, name
        if cap <= 40:
            assert bool(valid.all()), name
        # the padding is zero and invalid
        pad = args[2].reshape(B, K, T)[:, k, topk[name]:]
        assert not bool(pad.any()), name
        assert not bool(args[0].reshape(B, K, T, 11)[:, k, topk[name]:]
                        .any()), name


def test_plain_rows_with_caps_equal_rows_alone():
    """``weighted_nms_plain`` over rows of other keep caps, with zero,
    invalid columns padding a row past its candidates, gives each row what
    a call on its own candidates and cap gives: validity and scores bit
    for bit, the weighted rows within ``_gap_bound``; the rows past a
    row's cap are zero and invalid."""
    g = torch.Generator().manual_seed(5)
    F_, K = 6, 96
    ctr = torch.rand(F_, K, 2, generator=g) * 30
    lw = torch.rand(F_, K, 2, generator=g) * 2 + torch.tensor([3.5, 1.6])
    yaw = torch.rand(F_, K, generator=g) * 6.28 - 3.14
    c, s = torch.cos(yaw)[..., None], torch.sin(yaw)[..., None]
    lx = torch.tensor([0.5, -0.5, -0.5, 0.5]) * lw[..., :1]
    wy = torch.tensor([-0.5, -0.5, 0.5, 0.5]) * lw[..., 1:]
    corners = torch.stack([ctr[..., :1] + lx * c - wy * s,
                           ctr[..., 1:] + lx * s + wy * c], -1)
    dets = torch.cat([corners.reshape(F_, K, 8), yaw[..., None],
                      torch.full((F_, K, 1), -1.0),
                      torch.full((F_, K, 1), 1.6)], -1)
    scores = torch.rand(F_, K, generator=g)
    keep, counts = [12, 5, 30], [96, 40, 64]
    pads = torch.arange(K) >= torch.tensor(counts * 2)[:, None]
    dets[pads] = 0.0
    valid = (scores > 0.2) & ~pads
    kw = dict(thresh=0.1, thresh_vote=0.5, iou_3d=False, block=16)
    rows, rv = nms.weighted_nms_plain(dets, scores, valid, max_keep=keep,
                                      **kw)
    assert tuple(rows.shape) == (F_, 30, 12)
    bound = _gap_bound(dets, valid)
    for f in range(F_):
        cap, n = keep[f % 3], counts[f % 3]
        one, ov = nms.weighted_nms_plain(dets[f, :n], scores[f, :n],
                                         valid[f, :n], max_keep=cap, **kw)
        _close_rows(rows[f, :cap][None], rv[f, :cap][None], one[None],
                    ov[None], bound[f:f + 1])
        assert not bool(rv[f, cap:].any())
        assert not bool(rows[f, cap:].any())
    # the single-frame form and an int cap are the call of before
    one, ov = nms.weighted_nms_plain(dets[0], scores[0], valid[0],
                                     max_keep=12, **kw)
    assert torch.equal(one, rows[0, :12]) and torch.equal(ov, rv[0, :12])
    with pytest.raises(ValueError):
        nms.weighted_nms_plain(dets, scores, valid, max_keep=[3, -1], **kw)


def test_fold_against_the_benchmark_reference():
    """The fold on the program's own tiny multiclass forward from the
    benchmark's seeded weights, against ``portbench/reference/post.py``
    (a survivor at a time, f32 sums in its own order)."""
    import json

    from portbench import run
    from portbench.reference.post import run_inference as ref_inference
    from portbench.traffic.frames import make_pool
    from portbench.weights import model_weights
    from rangedet_tpu_torch.infer import build_eval_inputs
    from rangedet_tpu_torch.models import RangeDet

    config = json.loads((run.ROOT / "portbench" / "configs"
                         / f"{MULTI}.json").read_text())
    config["config"].update(
        feat_size=[16, 128], pad_field=[16, 128], max_gt_boxes=32,
        num_block={"res1": 2, "res2a": 1, "res2": 1, "res3a": 1, "res3": 1,
                   "agg1": 1, "agg2": 1, "agg2a": 1, "agg3": 1},
        num_filter={"res1": 16, "res2a": 16, "res2": 32, "res3a": 32,
                    "res3": 32, "agg1": 16, "agg2": 32, "agg2a": 16,
                    "agg3": 16},
        meta_units={"res1_unit2": {"channel_list": [8, 16]}},
        cls_conv_layers=1, cls_conv_channel=32, reg_conv_layers=1,
        reg_conv_channel=32, dtype="float32",
        device_topk={"veh": 256, "ped": 128, "cyc": 192},
        post_nms_top_n={"veh": 50, "ped": 20, "cyc": 10})
    c = config["config"]
    traffic = dict(json.loads((run.ROOT / "portbench" / "traffic"
                               / "eval_b4.json").read_text()),
                   boxes_per_frame=4, pool_batches=1)
    dev = torch.device("cpu")
    seed = 2 ** 31 + 24
    (raw,) = [run.to_device(b, dev) for b in make_pool(seed, traffic, c)]
    cfg = run.port_config(config, False)
    model = RangeDet(**cfg.model_kwargs())
    model.load_state_dict(model_weights(c, seed, dev), strict=True)
    model.eval()
    batch = build_eval_inputs(raw, cfg, dev)
    with torch.no_grad():
        cls, reg = model(batch["input_data"], batch["coord"])
        got = detector.run_inference(cls, reg, batch, cfg)
        loop = per_class_loop(cls, reg, batch, cfg)
    _same_outputs(got, loop)
    s = c["fpn_strides"]
    want = ref_inference(cls, reg, [batch[f"pc_s{i}"] for i in s],
                         [batch[f"mask_s{i}"] for i in s], c)
    assert list(want) == ["veh", "ped", "cyc"]
    for name, r in want.items():
        assert torch.equal(got[name]["valid"], r["valid"]), name
        assert int(r["valid"].sum()) > 0, name
        v = r["valid"]
        ref = r["boxes"][v]
        assert bool(((got[name]["boxes"][v] - ref).abs()
                     <= 1e-5 + 1e-6 * ref.abs()).all()), name
        assert torch.equal(got[name]["truncated"], r["truncated"]), name


def test_eval_ranges_once_a_step_over_three_classes():
    cfg = load_config(MULTI, False).replace(
        device_topk={"veh": 128, "ped": 64, "cyc": 96})
    cls, reg, batch = _heads(cfg, 2, 8, 64, seed=3)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        detector.run_inference(cls, reg, batch, cfg)
    names = [e.name for e in prof.events()]
    assert names.count("topk") == names.count("decode") == 1
    assert names.count("wnms") == 1
    assert names.count("wnms.round") > 1


def _multiclass_eval_b4(dev):
    """The benchmark's ``multiclass.eval.b4`` content on ``dev``: (cfg,
    model, the 8 batches as the eval step takes them)."""
    from portbench.run import content_seed, load_spec, port_config, to_device
    from portbench.traffic.frames import make_pool
    from portbench.weights import model_weights
    from rangedet_tpu_torch.infer import build_eval_inputs
    from rangedet_tpu_torch.models import RangeDet

    _, _, config, traffic = load_spec("multiclass.eval.b4")
    c, seed = config["config"], content_seed(0, traffic)
    cfg = port_config(config, False)
    model = RangeDet(**cfg.model_kwargs()).to(dev)
    model.load_state_dict(model_weights(c, seed, dev), strict=True)
    model.eval()
    inputs = [build_eval_inputs(to_device(b, dev), cfg, dev)
              for b in make_pool(seed, traffic, c)]
    return cfg, model, inputs


@pytest.mark.cuda
def test_fold_equals_the_per_class_loop_on_cuda():
    """On the card, over ``multiclass.eval.b4``'s 8 batches at full size:
    the fold's outputs equal the per-class loop's (three kernel launches)
    bit for bit, in one kernel launch a step, each class at its
    4096-candidate cap."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode at "
                    "full size")
    dev = torch.device("cuda")
    cfg, model, inputs = _multiclass_eval_b4(dev)
    assert cfg.class_names == ("veh", "ped", "cyc")
    with torch.inference_mode():
        for i, batch in enumerate(inputs):
            cls, reg = model(batch["input_data"], batch["coord"])
            n0 = nms.LAUNCHES
            got = detector.run_inference(cls, reg, batch, cfg)
            assert nms.LAUNCHES == n0 + 1, i
            want = per_class_loop(cls, reg, batch, cfg)
            assert nms.LAUNCHES == n0 + 1 + cfg.num_classes, i
            _same_outputs(got, want)
            for name in cfg.class_names:
                assert tuple(got[name]["boxes"].shape) == (
                    4, cfg.post_nms_top_n[name], 8)
                assert int(got[name]["valid"].sum()) > 0, (i, name)
