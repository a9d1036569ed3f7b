from x264_tpu_torch.rc.ratecontrol import RateControl, aq_offsets  # noqa: F401
