"""The first design of the CAVLC pair, kept so that it can be timed beside
the current kernels on one card in one call (chip_smoke.py does).

- ``tools/cavlc_v1/cavlc_blocks.cu``: a thread a block on (B, 16)
  zigzag levels with blen, nC and a gate, which ``ops/cavlc.block_inputs``
  gathers from the frame cores' fields (about thirty small PyTorch ops);
  the table copied into shared memory by every CTA of 64 blocks.
- ``tools/cavlc_v1/bitpack.cu``: a warp an MB walking one (N, S) slot
  grid in dependent rounds of 32 slots; the header and residual grids
  concatenated before it, words, nbits and fields after it, and the MBs'
  strings merged on the host (``bitstream/slice_assemble``).

``build_start()`` starts one ``nvcc`` per source (sm_90a, as
``kernels/build.py``) into ``x264_tpu_torch/build/cavlc_v1``;
``build_wait()`` links and loads them and returns a ``V1`` whose
methods run that path as it ran: ``slots`` (block_inputs, then the v1
wrapper with its conversions and per-call queries), ``blob`` (the
concatenations around the v1 packer), and ``alone`` (the two launches
on inputs and outputs made once).  The library's ptxas report is
``V1.log``."""

from __future__ import annotations

import ctypes
import os
import subprocess

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "tools", "cavlc_v1")
OUT = os.path.join(REPO, "x264_tpu_torch", "build", "cavlc_v1")
_P, _I = ctypes.c_void_p, ctypes.c_int


def build_start() -> list:
    """Start nvcc on both sources; returns the running compiles."""
    from x264_tpu_torch.kernels.build import NVCC_FLAGS, _nvcc
    os.makedirs(OUT, exist_ok=True)
    procs = []
    for name in ("cavlc_blocks", "bitpack"):
        obj = os.path.join(OUT, name + ".o")
        procs.append((name, obj, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-c", os.path.join(SRC, name + ".cu"),
             "-o", obj], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    return procs


def build_wait(procs) -> "V1":
    """Wait for the compiles, link, load."""
    from x264_tpu_torch.kernels.build import ARCH, _nvcc
    log, objs = "", []
    for name, obj, p in procs:
        out = p.communicate()[0]
        log += f"== {name}.cu (v1)\n{out}"
        if p.returncode:
            raise RuntimeError(f"nvcc failed on the v1 {name}.cu:\n{out}")
        objs.append(obj)
    so = os.path.join(OUT, "libcavlc_v1.so")
    r = subprocess.run([_nvcc(), *ARCH, "-shared", "-o", so, *objs],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc link failed: {r.stdout}{r.stderr}")
    lib = ctypes.CDLL(so)
    for name, args in (("cavlc_blocks_launch", [_P] * 7 + [_I, _P]),
                       ("cavlc_table_len", []),
                       ("bitpack_launch", [_P] * 4 + [_I] * 3 + [_P]),
                       ("bitpack_max_words", [])):
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return V1(lib, log)


class V1:
    """The v1 path, its wrappers' Python as it was."""

    def __init__(self, lib, log: str):
        self.lib, self.log = lib, log

    def _check(self, err: int, name: str) -> None:
        if err:
            raise RuntimeError(f"v1 {name}: CUDA error {err}")

    def code_blocks_(self, coefs, blen, nC, gate):
        """The v1 wrapper of cavlc_blocks: (B, 16) blocks -> (vals, lens)
        (B, 36)."""
        import torch
        from x264_tpu_torch.kernels.cavlc import TABLE_LEN, tables_on
        nb, dev = coefs.shape[0], coefs.device
        lib = self.lib
        tab = tables_on(str(dev))["block"][:TABLE_LEN]
        if tab.numel() != lib.cavlc_table_len():
            raise ValueError("v1 cavlc_blocks: table length")
        c = coefs.to(torch.int32).contiguous()
        bl = blen.to(torch.int32).contiguous()
        nc = nC.to(torch.int32).contiguous()
        g = gate.to(torch.uint8).contiguous()
        vals = torch.empty((nb, 36), dtype=torch.int32, device=dev)
        lens = torch.empty((nb, 36), dtype=torch.int32, device=dev)
        self._check(lib.cavlc_blocks_launch(
            c.data_ptr(), bl.data_ptr(), nc.data_ptr(), g.data_ptr(),
            tab.data_ptr(), vals.data_ptr(), lens.data_ptr(), nb,
            torch.cuda.current_stream(dev).cuda_stream), "cavlc_blocks")
        return vals, lens

    def pack_tokens_(self, vals, lens, n_words: int):
        """The v1 wrapper of bitpack: (N, S) grids -> (words, nbits)."""
        import torch
        if not 1 <= n_words <= self.lib.bitpack_max_words():
            raise ValueError("v1 bitpack: n_words")
        v = vals.to(torch.int32).contiguous()
        ln = lens.to(torch.int32).contiguous()
        n, s = v.shape
        words = torch.empty((n, n_words), dtype=torch.int32, device=v.device)
        nbits = torch.empty(n, dtype=torch.int32, device=v.device)
        self._check(self.lib.bitpack_launch(
            v.data_ptr(), ln.data_ptr(), words.data_ptr(), nbits.data_ptr(),
            n, s, n_words, torch.cuda.current_stream(v.device).cuda_stream),
            "bitpack")
        return words, nbits

    def slots(self, fields, mbw: int, mbh: int):
        """The v1 residual_slots: block_inputs, then the v1 block coder."""
        from x264_tpu_torch.ops.cavlc import block_inputs
        n = mbw * mbh
        vals, lens = self.code_blocks_(*block_inputs(*fields, mbw, mbh))
        return vals.reshape(n, -1), lens.reshape(n, -1)

    def blob(self, hv, hl, rv, rl, n_words: int, fields):
        """The v1 cavlc_blob: the grids concatenated, packed, and words,
        nbits and fields concatenated."""
        import torch
        words, nbits = self.pack_tokens_(torch.cat([hv, rv], dim=1),
                                         torch.cat([hl, rl], dim=1), n_words)
        return torch.cat([words, nbits[:, None]]
                         + [f.to(torch.int32)[:, None] for f in fields],
                         dim=1)

    def alone(self, fields, mbw: int, mbh: int, vals, lens, n_words: int):
        """(blocks, pack): the v1 launches alone, cavlc_blocks on the
        frame's block inputs and bitpack on the (N, S) grids ``vals`` and
        ``lens``, inputs and outputs made once (each call launches on the
        current stream, so a CUDA graph can capture them)."""
        import torch
        from x264_tpu_torch.kernels.cavlc import TABLE_LEN, tables_on
        from x264_tpu_torch.ops.cavlc import block_inputs
        coefs, blen, nc, gate = block_inputs(*fields, mbw, mbh)
        dev = coefs.device
        g8 = gate.to(torch.uint8)
        tab = tables_on(str(dev))["block"][:TABLE_LEN]
        nb, (n, s) = coefs.shape[0], vals.shape
        bv = torch.empty((nb, 36), dtype=torch.int32, device=dev)
        bl = torch.empty_like(bv)
        words = torch.empty((n, n_words), dtype=torch.int32, device=dev)
        nbits = torch.empty(n, dtype=torch.int32, device=dev)
        lib = self.lib

        def blocks():
            self._check(lib.cavlc_blocks_launch(
                coefs.data_ptr(), blen.data_ptr(), nc.data_ptr(),
                g8.data_ptr(), tab.data_ptr(), bv.data_ptr(), bl.data_ptr(),
                nb, torch.cuda.current_stream().cuda_stream), "cavlc_blocks")

        def pack():
            self._check(lib.bitpack_launch(
                vals.data_ptr(), lens.data_ptr(), words.data_ptr(),
                nbits.data_ptr(), n, s, n_words,
                torch.cuda.current_stream().cuda_stream), "bitpack")
        return blocks, pack
