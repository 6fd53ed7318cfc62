"""Multi-class veh + ped + cyc, full data, 36 epochs, with the geometric
augmentations on, mirroring rangedet_tpu/configs/rangedet_multiclass_all_36e.py:
the class-aware target expansion and the per-class prediction paths
(num_classes=3).
"""
from rangedet_tpu_torch.configs.base import RangeDetConfig


def get_config(is_train: bool) -> RangeDetConfig:
    return RangeDetConfig(
        name="rangedet_multiclass_all_36e",
        is_train=is_train,
        # the fused Meta-Kernel block in training, as the JAX recipe ships
        use_pallas_meta=True,
        batch_image=2 if is_train else 1,
        label_set=(1, 2, 4),
        class_names=("veh", "ped", "cyc"),
        filter_class=("TYPE_VEHICLE", "TYPE_PEDESTRIAN", "TYPE_CYCLIST"),
        sampling_rate=1,
        end_epoch=36,
        lr_steps=(24, 30),
        augment=("flip", "rotation"),
    )
