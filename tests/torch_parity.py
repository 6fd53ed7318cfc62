"""Shared set-up for the parity tests of rangedet_tpu_torch against
rangedet_tpu: one configuration, one weight tree and one numpy batch feed
both sides."""
import dataclasses
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import torch

from rangedet_tpu.configs.base import RangeDetConfig as JaxConfig
from rangedet_tpu.models import RangeDet as JaxRangeDet
from rangedet_tpu_torch.configs.base import RangeDetConfig as TorchConfig
from rangedet_tpu_torch.convert import from_flax
from rangedet_tpu_torch.models import RangeDet

BOX_ATOL = 1e-3
# scores the two frameworks compute differ by ~1e-7 in f32; candidates
# closer than this to min_score or to each other could flip valid or swap
# greedy order, so the test asserts its inputs keep them apart
SCORE_MARGIN = 1e-3
ORDER_GAP = 1e-6

# JAX-only knobs the port's config leaves out (TPU layout, kernels,
# sharding, and the serial-WNMS prefilter the blocked form never reads)
SKIPPED_FIELDS = {
    "layout", "use_pallas_conv", "use_pallas_iou",
    "topk_method", "iou_chunk", "bn_sync_axis",
    "wnms_prefilter_topm",
}
DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def port_config(jcfg: JaxConfig) -> TorchConfig:
    """The port's config with every shared field taken from ``jcfg``."""
    kw = {f.name: getattr(jcfg, f.name)
          for f in dataclasses.fields(TorchConfig)}
    kw["dtype"] = DTYPES[jcfg.dtype]
    return TorchConfig(**kw)


def init_jax(cfg: JaxConfig, batch):
    model = JaxRangeDet(**cfg.model_kwargs())
    v = jax.jit(model.init, static_argnums=(3,))(
        jax.random.PRNGKey(0), jnp.asarray(batch["input_data"]),
        jnp.asarray(batch["coord"]), False,
    )
    return model, v


def perturb(variables, seed=0, cls_bias_shift=0.0):
    """Seeded noise on every BN scale/bias/mean/var so eval BN is no
    near-identity, and an optional shift of the cls logit biases. Returns
    (params, batch_stats) as numpy trees."""
    r = np.random.RandomState(seed)

    def walk(tree, path=()):
        out = {}
        for k, v in tree.items():
            if hasattr(v, "items"):
                out[k] = walk(v, path + (k,))
                continue
            a = np.array(v, np.float32)
            if k == "scale":
                a = a * r.uniform(0.7, 1.3, a.shape).astype(np.float32)
            elif k == "bias" and path and "bn" in path[-1]:
                a = a + 0.1 * r.randn(*a.shape).astype(np.float32)
            elif k == "mean":
                a = a + 0.1 * r.randn(*a.shape).astype(np.float32)
            elif k == "var":
                a = a * r.uniform(0.5, 1.5, a.shape).astype(np.float32)
            elif k.startswith("cls_logit") and k.endswith("_bias"):
                a = a + np.float32(cls_bias_shift)
            out[k] = a
        return out

    return walk(variables["params"]), walk(variables["batch_stats"])


def port_model(pcfg: TorchConfig, params, batch_stats) -> RangeDet:
    model = RangeDet(**pcfg.model_kwargs())
    model.load_state_dict(from_flax(params, batch_stats), strict=True)
    return model.eval()


# tests/tiny.py's overrides for the port's config (no jax import)
TINY_PORT_CONFIG = textwrap.dedent("""
    import torch
    from rangedet_tpu_torch.configs import load_config

    def get_config(is_train):
        return load_config("rangedet_veh_wo_aug_4_18e", is_train).replace(
            feat_size=(16, 128), pad_field=(16, 128), max_gt_boxes=32,
            num_block={"res1": 2, "res2a": 1, "res2": 1, "res3a": 1,
                       "res3": 1, "agg1": 1, "agg2": 1, "agg2a": 1,
                       "agg3": 1},
            num_filter={"res1": 16, "res2a": 16, "res2": 32, "res3a": 32,
                        "res3": 32, "agg1": 16, "agg2": 32, "agg2a": 16,
                        "agg3": 16},
            meta_units={"res1_unit2": dict(channel_list=(8, 16))},
            cls_conv_layers=1, cls_conv_channel=32, reg_conv_layers=1,
            reg_conv_channel=32, device_topk={"veh": 256}, iou_topk_gt=8,
            dtype=torch.float32,
        )
""")


def masked_logits(model, tbatch):
    """(B, N, K) logits of every level, -50 outside the masks."""
    with torch.inference_mode():
        logits, _ = model(tbatch["input_data"], tbatch["coord"])
    B, K = logits[0].shape[0], logits[0].shape[-1]
    lg = torch.cat([l.reshape(B, -1, K) for l in logits], 1)
    mask = torch.cat([tbatch[f"mask_s{s}"].reshape(B, -1)
                      for s in (1, 2, 4)], 1)
    return torch.where(mask[..., None] > 0, lg,
                       torch.full_like(lg, -50.0)).numpy()


def check_eval_step(jax_layout: str, use_pallas_meta: bool,
                    recipe: str = "rangedet_veh_wo_aug_4_18e",
                    **overrides) -> None:
    """The port's whole eval step (tiny config of ``recipe``, f32, two
    frames) against the JAX one run in ``jax_layout`` ("bhcw", or "nhwc"
    whose Meta-Kernel runs the Pallas kernel interpreted when
    ``use_pallas_meta``), on one weight tree: per class, boxes to
    BOX_ATOL, valid masks and truncation flags exact, with the class's
    min_score and candidate cap placed in gaps of its scores, so rounding
    noise decides neither. ``overrides``: fields of the tiny config (such
    as a recipe's own channel widths)."""
    from rangedet_tpu.data.synthetic import make_batch
    from rangedet_tpu.models.convert import convert_params
    from rangedet_tpu.train.train_step import build_eval_inputs as jax_inputs
    from rangedet_tpu.train.train_step import make_eval_step as jax_eval_step
    from rangedet_tpu_torch.infer import build_eval_inputs, make_eval_step
    from tiny import tiny_config

    jcfg = tiny_config(recipe, is_train=False, layout="bhcw",
                       dtype=jnp.float32, use_pallas_meta=use_pallas_meta,
                       **overrides)
    batch = make_batch(jcfg, 2, seed=11, num_boxes=6)
    _, v = init_jax(jcfg, batch)
    params, stats = perturb(v, seed=7)
    head = params["head"]
    for lvl in range(3):  # spread the logits so scores are well apart
        head[f"cls_logit_lvl_{lvl}_kernel"] *= 100.0

    # per class, place min_score in a gap of both frames' scores, with the
    # frames' candidate counts apart, so a cap between them truncates one
    # frame
    pcfg = port_config(jcfg)
    tb = build_eval_inputs(batch, pcfg, torch.device("cpu"))
    lg = masked_logits(port_model(pcfg, params, stats), tb).astype(np.float64)
    shifts, n_valid = [], {}
    for k, name in enumerate(jcfg.class_names):
        ms = jcfg.min_score[name]
        thr = np.log(ms / (1 - ms))  # the logit of min_score
        desc = np.sort(lg[0, :, k])[::-1]
        for i in range(30, 90):
            shift = thr - 0.5 * (desc[i - 1] + desc[i])
            scores = 1 / (1 + np.exp(-(lg[..., k] + shift)))
            nv = (scores > ms).sum(axis=1)
            # the trap: scores near min_score would be decided by rounding
            if (np.abs(scores - ms).min() > SCORE_MARGIN
                    and abs(nv[1] - nv[0]) >= 4):
                break
        else:
            raise AssertionError(f"no {name} min_score gap clear of both "
                                 "frames' scores")
        shifts.append(shift)
        n_valid[name] = nv
    for lvl in range(3):
        head[f"cls_logit_lvl_{lvl}_bias"] += np.float32(shifts)
    topk = {name: int(min(nv) + abs(nv[1] - nv[0]) // 2)
            for name, nv in n_valid.items()}
    jcfg = jcfg.replace(device_topk=topk)
    pcfg = port_config(jcfg)
    model = port_model(pcfg, params, stats)
    scores = 1 / (1 + np.exp(-masked_logits(model, tb).astype(np.float64)))
    for k, name in enumerate(jcfg.class_names):
        ms, sk = jcfg.min_score[name], scores[..., k]
        assert ((sk > ms).sum(axis=1) == n_valid[name]).all()
        assert np.abs(sk - ms).min() > SCORE_MARGIN
        top = np.sort(sk, axis=1)[:, ::-1][:, : topk[name] + 1]
        assert np.diff(-top, axis=1).min() > ORDER_GAP

    jcfg = jcfg.replace(layout=jax_layout)
    jmodel = JaxRangeDet(**jcfg.model_kwargs())
    jparams = (convert_params(params, "nhwc") if jax_layout == "nhwc"
               else params)
    jstep = jax.jit(lambda p, s, b: jax_eval_step(jmodel, jcfg)(
        type("S", (), {"params": p, "batch_stats": s})(),
        jax_inputs(b, jcfg)))
    want = jstep(jparams, stats,
                 {k: jnp.asarray(x) for k, x in batch.items()})
    got = make_eval_step(model, pcfg)(build_eval_inputs(batch, pcfg,
                                                        torch.device("cpu")))
    assert sorted(got) == sorted(want) == sorted(jcfg.class_names)
    for name in jcfg.class_names:
        w, g = want[name], got[name]
        np.testing.assert_array_equal(g["truncated"].numpy(),
                                      np.asarray(w["truncated"]))
        assert g["truncated"].numpy().tolist() == [
            bool(n > topk[name]) for n in n_valid[name]]
        gv = g["valid"].numpy()
        np.testing.assert_array_equal(gv, np.asarray(w["valid"]))
        assert gv.sum(axis=1).min() >= 3
        np.testing.assert_allclose(g["boxes"].numpy()[gv],
                                   np.asarray(w["boxes"])[gv], atol=BOX_ATOL)
