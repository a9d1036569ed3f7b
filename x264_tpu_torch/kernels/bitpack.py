"""Per-MB bit packing of token slots: the wrapper of the CUDA kernel
``csrc/bitpack.cu`` (a warp per MB) and its plain PyTorch twin.

Replaces x264_tpu/ops/device/bitpack.py::pack_tokens, which the
reference runs as XLA (a ``lax.scan`` over the slots; no Pallas kernel).
Tokens are appended in slot order to a big-endian bitstring per MB (bit
0 of the stream is the MSB of word 0); a slot of length 0 is a no-op.
Values fit their lengths (CAVLC codes and exp-Golomb header codes, at
most 30 bits).  Words come back as int32 bit patterns of the uint32
words (the reference's ``bitcast_convert_type``), with nbits the MB's
whole length: an MB past ``32 * n_words`` bits keeps its first words and
drops the rest, as the scan does, so the caller sees the overflow in
nbits and re-runs at a larger budget."""

from __future__ import annotations

import torch

from x264_tpu_torch.kernels import LAUNCHES
from x264_tpu_torch.kernels.build import check, library

_I32 = torch.int32
_I64 = torch.int64
_MASK32 = 0xFFFFFFFF


def _int32_bits(w):
    """uint32 values held in int64 -> the same bits as int32."""
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(_I32)


def pack_tokens_plain(vals, lens, n_words: int):
    """Plain twin of ``pack_tokens``: each token's bit position from an
    exclusive cumsum of the lengths, then its one or two parts added into
    (N, n_words + 1) int64 words (the bit ranges are disjoint, so the sum
    is the OR; column n_words takes what falls past the budget) and the
    words cut to n_words."""
    n, _ = vals.shape
    v = vals.to(_I64)
    live = lens > 0
    ln = torch.where(live, lens, 0).to(_I64)
    incl = torch.cumsum(ln, dim=1)
    pos = incl - ln
    sh = pos & 31
    w0 = pos >> 5
    fits = sh + ln <= 32
    part0 = torch.where(fits, v << (32 - sh - ln).clamp(min=0),
                        v >> (sh + ln - 32).clamp(min=0)) & _MASK32
    part1 = (v << (64 - sh - ln).clamp(max=63)) & _MASK32
    part0 = torch.where(live, part0, 0)
    part1 = torch.where(live & ~fits, part1, 0)
    words = torch.zeros((n, n_words + 1), dtype=_I64, device=vals.device)
    words.scatter_add_(1, w0.clamp(max=n_words), part0)
    words.scatter_add_(1, (w0 + 1).clamp(max=n_words), part1)
    nbits = incl[:, -1] if incl.shape[1] else torch.zeros(
        n, dtype=_I64, device=vals.device)
    return _int32_bits(words[:, :n_words]), nbits.to(_I32)


def max_words() -> int:
    """The largest n_words the kernel takes (its shared word buffers)."""
    return library().bitpack_max_words()


def work(n: int, s: int, n_words: int) -> int:
    """Bytes of one call: vals and lens read once, words and nbits
    written once."""
    return 8 * n * s + 4 * n * (n_words + 1)


def pack_tokens_(vals, lens, n_words: int):
    """Launch the kernel on CUDA tensors: (N, S) int32 vals and lens ->
    (words (N, n_words) int32, nbits (N,) int32)."""
    if vals.dim() != 2 or lens.shape != vals.shape:
        raise ValueError(f"bitpack: vals {tuple(vals.shape)} and lens "
                         f"{tuple(lens.shape)} must both be (N, S)")
    if lens.device != vals.device:
        raise ValueError("bitpack: vals and lens on different devices")
    if not 1 <= n_words <= max_words():
        raise ValueError(f"bitpack: n_words {n_words} outside 1.."
                         f"{max_words()}")
    v = vals.to(_I32).contiguous()
    ln = lens.to(_I32).contiguous()
    n, s = v.shape
    words = torch.empty((n, n_words), dtype=_I32, device=v.device)
    nbits = torch.empty(n, dtype=_I32, device=v.device)
    stream = torch.cuda.current_stream(v.device).cuda_stream
    check(library().bitpack_launch(v.data_ptr(), ln.data_ptr(),
                                   words.data_ptr(), nbits.data_ptr(), n, s,
                                   n_words, stream), "bitpack")
    LAUNCHES["bitpack"] += 1
    return words, nbits


def pack_tokens(vals, lens, n_words: int):
    """(N, S) vals and lens -> (words (N, n_words) int32, nbits (N,)):
    the kernel on CUDA tensors, the plain twin on CPU tensors."""
    if vals.device.type == "cpu":
        return pack_tokens_plain(vals, lens, n_words)
    if vals.device.type != "cuda":
        raise ValueError(f"pack_tokens: no kernel for {vals.device}")
    return pack_tokens_(vals, lens, n_words)
