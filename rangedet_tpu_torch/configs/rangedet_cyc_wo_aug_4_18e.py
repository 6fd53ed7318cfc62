"""Cyclist-only, 1/4 data, 18 epochs, no augmentation, mirroring
rangedet_tpu/configs/rangedet_cyc_wo_aug_4_18e.py (the reference ships no
cyclist recipe; its per-class tables cover TYPE_CYCLIST=4).
"""
from rangedet_tpu_torch.configs.base import RangeDetConfig


def get_config(is_train: bool) -> RangeDetConfig:
    return RangeDetConfig(
        name="rangedet_cyc_wo_aug_4_18e",
        is_train=is_train,
        # the fused Meta-Kernel block in training, as the JAX recipe ships
        use_pallas_meta=True,
        batch_image=2 if is_train else 1,
        label_set=(4,),
        class_names=("cyc",),
        filter_class=("TYPE_CYCLIST",),
        sampling_rate=4,
        end_epoch=18,
        lr_steps=(12, 15),
    )
