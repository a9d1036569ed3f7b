"""x264_tpu_torch — the PyTorch + CUDA port of x264_tpu's encoder.

The package stands alone: it imports neither JAX nor ``x264_tpu``.  Its
host layer is its own copy of the reference's framework-free code, and
what ran on the TPU runs on PyTorch tensors:

  params.py, utils/, bitstream/, rc/
            — host layer copied from x264_tpu: parameters, the frame
              container, SPS/PPS/SEI/slice-header writers, CAVLC's
              tables and the host merge of packed MB strings (the
              tests' oracle: the card places the strings), the
              host-syntax path's CAVLC writers (cavlc, cavlc_vec,
              slice_writer, slice_writer_vec), rate control
  native/   — the C CABAC coder (a copy of x264_tpu/native), built with
              gcc at first use (ops/entropy_pack.py)
  ops/      — primitive ops on tensors (pixel, transform, predict, mc,
              me, me_parts, header, entropy_pack, deblock), CAVLC's
              residual slots and blob with their plain twins (cavlc),
              and the trellis's host tables and plain twin (trellis)
  models/   — frame cores: the I16 wavefront (intra), the P pipeline
              (inter, P16x16 or P8x8 partitions, one or more
              references, fullpel only at subpel 0; p_band_core, its
              band entry) and the B frames (b_frame), with their
              residual paths (4x4 or 8x8, deadzone or trellis), and
              weighted prediction (weightp: the host analysis, the
              weighting step); the host-syntax path's FrameSyntax
              (syntax) and the NumPy tier of backend="reference"
              (intra_frame, inter_frame, mvpred, with ops/reference/),
              copies of x264_tpu's
  kernels/  — wrappers, plain twins and the nvcc build of the
              hand-written CUDA kernels in csrc/
  state.py  — constant tables (copied from x264_tpu) on a device,
              reference-output conversion
  parallel/ — the band mesh (sliced): with ``threads`` > 1 a CAVLC P
              frame's bands run one a card
  api.py    — ``Encoder(params, device)``: one slice, or bands of MB
              rows each coded as a slice (``slices`` > 1)
  cli.py, output/, utils/y4m.py, utils/filters.py, utils/metrics.py
            — the command line (copies of x264_tpu's but for
              ``--device``): ``python -m x264_tpu_torch --device cpu``
              runs the plain twins, the default ``cuda`` the kernels

``Encoder(..., device="cuda")`` raises when no CUDA device is present;
``device="cpu"`` runs the kernels' plain twins.
"""

from x264_tpu_torch.kernels import LAUNCHES

__version__ = "0.1.0"


def launch_counts() -> dict:
    """Kernel launches counted by the wrappers since the last reset."""
    return dict(LAUNCHES)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
