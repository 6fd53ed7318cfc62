"""RangeDetConfig for the PyTorch port: every field of
``rangedet_tpu.configs.base.RangeDetConfig`` but the TPU-only ones, with the
same names and defaults, and ``dtype`` as a ``torch.dtype``.
``use_pallas_meta`` keeps its name: in the port it selects the fused
Meta-Kernel block in training (``ops/meta_block.py``) and the taps' kernel
in eval (``ops/meta_kernel.py``).

``remat`` and ``remat_meta`` keep theirs: ``torch.utils.checkpoint`` over
every backbone stage, and over the materialized Meta-Kernel block.

``mesh_shape`` is the mesh, ``{"data": D, "model": M}`` over D*M
processes (the train CLI's ``--mesh``); a "model" axis shards the range
image's width. ``width_axis`` keeps its name and meaning: "model" where
the train CLI trains on a width mesh (it then gives the model its width
group, ``models/layers.py:set_width_group``), None otherwise.

Left out are the JAX package's TPU-only knobs: ``layout``,
``use_pallas_conv``, ``use_pallas_iou``, ``topk_method``, ``iou_chunk``,
``bn_sync_axis`` (the train CLI sets the BatchNorms' sync
group instead, ``models/layers.py:set_sync_group``), and
``wnms_prefilter_topm``, which only the serial WNMS form reads (the port
runs the blocked form, ``wnms_block > 0``).
``tests/test_torch_model.py`` holds the two dataclasses against each other.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import torch


@dataclasses.dataclass
class RangeDetConfig:
    # ------------------------------------------------------------- general
    name: str = "rangedet"
    is_train: bool = True
    batch_image: int = 2
    log_frequency: int = 100
    feat_size: Tuple[int, int] = (64, 2650)
    pad_field: Tuple[int, int] = (64, 2656)
    label_set: Sequence[int] = (1,)  # Waymo enum values (1=veh, 2=ped, 4=cyc)
    class_names: Sequence[str] = ("veh",)

    # ------------------------------------------------------------- pyramid
    fpn_strides: Sequence[int] = (1, 2, 4)
    fpn_intervals: Dict[int, Tuple[float, float]] = dataclasses.field(
        default_factory=lambda: {1: (30, 100), 2: (15, 30), 4: (0, 15)}
    )

    # ------------------------------------------------------------- model
    num_block: Optional[Dict[str, int]] = None  # None -> DLA defaults
    num_filter: Optional[Dict[str, int]] = None
    meta_units: Optional[Dict[str, dict]] = None  # None -> res1_unit2 default
    add_data_sc: bool = True
    num_reg_delta: int = 8
    cls_conv_layers: int = 4
    cls_conv_channel: int = 128
    reg_conv_layers: int = 4
    reg_conv_channel: int = 128
    dtype: Any = torch.bfloat16
    # the Meta-Kernel's kernels: the fused block in training (kernels 3-5),
    # the materialized block with the taps' kernel in eval (kernel 7)
    use_pallas_meta: bool = False
    # recompute each backbone stage's forward in the backward
    # (torch.utils.checkpoint; the reference's memonger, config:169)
    remat: bool = False
    # recompute the materialized Meta-Kernel block (its 9C taps) in the
    # backward; the fused block keeps no 9C tensor and is never wrapped
    remat_meta: bool = False

    # ------------------------------------------------------------- loss
    vfl_alpha: float = 1.0
    vfl_gamma: float = 2.0
    cls_loss_weight: float = 10.0
    reg_loss_weight: float = 8.0
    smooth_l1_scalar: float = 3.0
    l1_loss: bool = False
    reg_dim_weights: Sequence[float] = (3, 1, 1, 1, 1, 1, 1, 1)
    iou_topk_gt: int = 24

    # ------------------------------------------------------------- targets
    max_gt_boxes: int = 200
    assign_radius_sq: float = 100.0
    assign_max_dist_sq: float = 20.0

    # ------------------------------------------------------------- test
    # reference candidate cap before min_score filtering
    pre_nms_top_n: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {"veh": 50000, "ped": 5000, "cyc": 5000}
    )
    # candidates carried into WNMS; run_inference flags a frame "truncated"
    # when this cap binds (the weakest kept candidate still clears min_score)
    device_topk: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {"veh": 4096, "ped": 4096, "cyc": 4096}
    )
    post_nms_top_n: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {"veh": 200, "ped": 200, "cyc": 100}
    )
    min_score: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {"veh": 0.5, "ped": 0.4, "cyc": 0.3}
    )
    eval_iou_thresh: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {"veh": 0.7, "ped": 0.5, "cyc": 0.5}
    )
    eval_iou_mode: str = "3d"
    wnms_thr_lo: float = 0.1
    wnms_thr_hi: float = 0.5
    wnms_is_3d: bool = False
    wnms_block: int = 16  # candidates per blocked greedy round (ops/nms.py)
    max_det_per_image: int = 100

    # ------------------------------------------------------------- optimize
    optimizer: str = "sgd"
    base_lr: float = 0.01 / 8 * 8 * 2 * 5
    auto_scale_lr: bool = True
    momentum: float = 0.9
    weight_decay: float = 1e-5
    clip_gradient: float = 35.0
    clip_mode: str = "elementwise"
    lr_mode: str = "cosine"
    begin_epoch: int = 0
    end_epoch: int = 18
    lr_steps: Sequence[int] = (12, 15)
    warmup_epochs: float = 2.0
    warmup_lr: float = 0.0
    onecycle_div_factor: float = 10.0
    onecycle_pct_start: float = 0.4
    onecycle_moms: Tuple[float, float] = (0.95, 0.85)
    adam_beta2: float = 0.999

    # ------------------------------------------------------------- data
    data_root: str = ""
    image_set: Any = ("training",)
    sampling_rate: int = 4
    filter_class: Sequence[str] = ("TYPE_VEHICLE",)
    loader_workers: int = 8
    augment: Sequence[str] = ()

    # ------------------------------------------------------------- parallel
    # {"data": D, "model": M}; None: all ranks on "data"
    mesh_shape: Optional[Dict[str, int]] = None
    sync_bn: bool = True  # global BN; False = per-rank ("localbn") stats
    # "model": the width is sharded over the mesh's model axis (set by the
    # train CLI for width meshes, with sync_bn forced); None: unsharded
    width_axis: Any = None

    # ------------------------------------------------------------- io
    experiment_dir: str = "experiments"
    checkpoint_every_epochs: int = 1

    @property
    def num_classes(self) -> int:
        return len(self.label_set)

    def model_kwargs(self) -> dict:
        return dict(
            fpn_strides=tuple(self.fpn_strides),
            num_classes=self.num_classes,
            num_reg_delta=self.num_reg_delta,
            num_block=self.num_block,
            num_filter=self.num_filter,
            meta_units=self.meta_units,
            add_data_sc=self.add_data_sc,
            cls_conv_layers=self.cls_conv_layers,
            cls_conv_channel=self.cls_conv_channel,
            reg_conv_layers=self.reg_conv_layers,
            reg_conv_channel=self.reg_conv_channel,
            dtype=self.dtype,
            use_pallas_meta=self.use_pallas_meta,
            remat=self.remat,
            remat_meta=self.remat_meta,
        )

    def replace(self, **kw) -> "RangeDetConfig":
        return dataclasses.replace(self, **kw)
