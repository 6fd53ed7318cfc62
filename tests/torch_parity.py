"""Shared set-up for the parity tests of rangedet_tpu_torch against
rangedet_tpu: one configuration, one weight tree and one numpy batch feed
both sides."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from rangedet_tpu.configs.base import RangeDetConfig as JaxConfig
from rangedet_tpu.models import RangeDet as JaxRangeDet
from rangedet_tpu_torch.configs.base import RangeDetConfig as TorchConfig
from rangedet_tpu_torch.convert import from_flax
from rangedet_tpu_torch.models import RangeDet

# JAX-only knobs the port's config leaves out (TPU layout, kernels, sharding,
# remat, and the serial-WNMS prefilter the blocked form never reads)
SKIPPED_FIELDS = {
    "layout", "use_pallas_conv", "use_pallas_iou",
    "topk_method", "iou_chunk", "width_axis", "bn_sync_axis", "remat",
    "remat_meta", "mesh_shape", "wnms_prefilter_topm",
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
