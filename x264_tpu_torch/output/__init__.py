"""Output muxers — the reference output/ directory analog (raw Annex-B,
FLV, MP4).  Each muxer consumes the encoder's Annex-B access units plus
the SPS/PPS and writes a container file.

Copied from x264_tpu/output/__init__.py; the port keeps its own copy."""

from x264_tpu_torch.output.mux import (FlvMuxer, MkvMuxer, Mp4Muxer, RawMuxer, annexb_to_avcc,
                                 extract_parameter_sets, open_muxer)

__all__ = ["RawMuxer", "FlvMuxer", "MkvMuxer", "Mp4Muxer", "open_muxer",
           "annexb_to_avcc", "extract_parameter_sets"]
