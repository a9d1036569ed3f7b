"""Hand-written CUDA kernels (csrc/*.cu) and their Python wrappers.

Each wrapper takes its kernel's plain PyTorch twin for tensors on the
CPU, launches the kernel for CUDA tensors, and counts its launches in
``LAUNCHES`` (one per wrapper call that launched the kernel), so a run
can show that the main path went through the kernels."""

LAUNCHES = {"esa16": 0, "deblock_luma": 0, "deblock_chroma": 0}
