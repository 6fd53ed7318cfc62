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
