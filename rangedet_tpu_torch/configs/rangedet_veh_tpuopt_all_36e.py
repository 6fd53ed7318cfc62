"""Wide-channel vehicle recipe: the parity architecture with the channel
widths raised (res1 128, res2/res3a/res3/agg2 256, the Meta-Kernel at C=128
with a 32-wide MLP), mirroring
rangedet_tpu/configs/rangedet_veh_tpuopt_all_36e.py. The capacity knob:
strictly more model than the published one; the parity-exact recipe remains
rangedet_veh_wo_aug_all_36e. Its fused Meta-Kernel block runs the kernels'
C=128 instance (csrc/meta_block.cu).
"""
from rangedet_tpu_torch.configs.base import RangeDetConfig


def get_config(is_train: bool) -> RangeDetConfig:
    return RangeDetConfig(
        name="rangedet_veh_tpuopt_all_36e",
        is_train=is_train,
        # the fused Meta-Kernel block in training, as the JAX recipe ships
        use_pallas_meta=True,
        batch_image=2 if is_train else 1,
        label_set=(1,),
        class_names=("veh",),
        filter_class=("TYPE_VEHICLE",),
        sampling_rate=1,
        end_epoch=36,
        lr_steps=(24, 30),
        num_filter={
            "res1": 128, "res2a": 128, "res2": 256, "res3a": 256, "res3": 256,
            "agg1": 128, "agg2": 256, "agg2a": 128, "agg3": 128,
        },
        meta_units={"res1_unit2": dict(channel_list=(32, 128))},
    )
