"""A tiny configuration and traffic for the CPU tests: every layer of the
model at a few channels, 16 x 128 frames, f32."""
TINY = dict(
    feat_size=[16, 128], pad_field=[16, 128], max_gt_boxes=32,
    num_block={"res1": 2, "res2a": 1, "res2": 1, "res3a": 1, "res3": 1,
               "agg1": 1, "agg2": 1, "agg2a": 1, "agg3": 1},
    num_filter={"res1": 16, "res2a": 16, "res2": 32, "res3a": 32, "res3": 32,
                "agg1": 16, "agg2": 32, "agg2a": 16, "agg3": 16},
    meta_units={"res1_unit2": {"channel_list": [8, 16]}},
    cls_conv_layers=1, cls_conv_channel=32, reg_conv_layers=1,
    reg_conv_channel=32, device_topk={"veh": 256, "ped": 256, "cyc": 256},
    dtype="float32")
TINY_TRAFFIC = dict(boxes_per_frame=4, pool_batches=3, trace_steps=2,
                    sample_from_steps=4, sample_steps=2)
