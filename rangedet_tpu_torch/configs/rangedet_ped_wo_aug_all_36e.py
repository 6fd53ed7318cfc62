"""Pedestrian-only, full data, 36 epochs (reference:
config/rangedet/rangedet_ped_wo_aug_all_36e.py), mirroring
rangedet_tpu/configs/rangedet_ped_wo_aug_all_36e.py.
"""
from rangedet_tpu_torch.configs.base import RangeDetConfig


def get_config(is_train: bool) -> RangeDetConfig:
    return RangeDetConfig(
        name="rangedet_ped_wo_aug_all_36e",
        is_train=is_train,
        # the fused Meta-Kernel block in training, as the JAX recipe ships
        use_pallas_meta=True,
        batch_image=2 if is_train else 1,
        label_set=(2,),
        class_names=("ped",),
        filter_class=("TYPE_PEDESTRIAN",),
        sampling_rate=1,
        end_epoch=36,
        lr_steps=(24, 30),
    )
