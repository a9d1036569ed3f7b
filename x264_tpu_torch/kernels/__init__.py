"""Hand-written CUDA kernels (csrc/*.cu) and their Python wrappers.

Each wrapper takes its kernel's plain PyTorch twin for tensors on the
CPU, launches the kernel for CUDA tensors, and counts its launches in
``LAUNCHES`` (one per wrapper call that launched the kernel; a CUDA
graph of an I core, ``models/graph.py``, adds its captured counts at
each replay), so a run can show that the main path went through the
kernels."""

LAUNCHES = {"esa16": 0, "esa_parts": 0, "deblock": 0, "trellis": 0,
            "intra_nxn": 0, "cavlc_blocks": 0, "bitpack": 0,
            "pir_column": 0}
