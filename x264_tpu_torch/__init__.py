"""x264_tpu_torch — the PyTorch + CUDA port of x264_tpu's device pipeline.

The encoder's host layer (parameters, bitstream writers, the C CABAC
coder, rate control, the NumPy reference tier) is imported from
``x264_tpu`` and needs no JAX; this package replaces what ran on the TPU:

  ops/      — primitive ops on tensors (pixel, transform, predict, mc,
              me, header, entropy_pack, deblock)
  models/   — frame cores: the I16 wavefront (intra) and the P16
              pipeline (inter), with their residual paths
  kernels/  — wrappers, plain twins and the nvcc build of the
              hand-written CUDA kernels in csrc/
  state.py  — constant tables on a device, reference-output conversion
  api.py    — ``Encoder(params, device)``

It never imports JAX.  ``Encoder(..., device="cuda")`` raises when no
CUDA device is present; ``device="cpu"`` runs the kernels' plain twins.
"""

from x264_tpu_torch.kernels import LAUNCHES

__version__ = "0.1.0"


def launch_counts() -> dict:
    """Kernel launches counted by the wrappers since the last reset."""
    return dict(LAUNCHES)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
