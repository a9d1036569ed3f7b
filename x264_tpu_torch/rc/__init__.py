from x264_tpu_torch.rc.ratecontrol import RateControl  # noqa: F401
