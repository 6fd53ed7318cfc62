"""The port's recipes, one module each, mirroring ``rangedet_tpu/configs/``
field by field but for the TPU-only fields (``base.py``):
rangedet_veh_wo_aug_4_18e, rangedet_veh_wo_aug_all_36e,
rangedet_ped_wo_aug_4_18e, rangedet_ped_wo_aug_all_36e,
rangedet_cyc_wo_aug_4_18e, rangedet_multiclass_all_36e (three classes,
trained with the host augmentation) and rangedet_veh_tpuopt_all_36e (the
wide-channel recipe, whose Meta-Kernel block runs the kernels' C=128
instance): all seven of the JAX package's.
"""
import importlib
import importlib.util


def load_config(name_or_path: str, is_train: bool = True):
    """Load a recipe by module name (e.g. 'rangedet_veh_wo_aug_4_18e') or
    filesystem path, as ``rangedet_tpu.configs.load_config`` does."""
    if name_or_path.endswith(".py"):
        spec = importlib.util.spec_from_file_location(
            "rangedet_tpu_torch_user_config", name_or_path
        )
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    else:
        mod = importlib.import_module(
            f"rangedet_tpu_torch.configs.{name_or_path}"
        )
    return mod.get_config(is_train)
