"""Per-MB bit packing of token slots and the placement of the MBs'
strings in the slice payload: the wrappers of the CUDA kernels
``csrc/bitpack.cu`` (``bitpack_launch``, the packing into the blob, and
``bitplace_launch``, the payload placed from that blob) and their plain
PyTorch twins.

Replaces x264_tpu/ops/device/bitpack.py::pack_tokens, which the
reference runs as XLA (a ``lax.scan`` over the slots; no Pallas kernel),
and the host merge after it (``bitstream/slice_assemble.merge_mb_strings``).
Tokens are appended in slot order to a big-endian bitstring per MB (bit
0 of the stream is the MSB of word 0); a slot of length 0 is a no-op.
Values fit their lengths (CAVLC codes and exp-Golomb header codes, at
most 30 bits).  Words come back as int32 bit patterns of the uint32
words (the reference's ``bitcast_convert_type``), with nbits the MB's
whole length: an MB past ``32 * n_words`` bits keeps its first words and
drops the rest, as the scan does, so the caller sees the overflow in
nbits and re-runs at a larger budget."""

from __future__ import annotations

import functools

import torch

from x264_tpu_torch.kernels import LAUNCHES
from x264_tpu_torch.kernels.build import check, check_tensors, library

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


def place_plain(words, nbits, pay_words: int):
    """Plain twin of the kernel's placement: each MB's first
    min(ceil(nbits / 32), n_words) words (N, n_words) shifted to its bit
    offset (the exclusive cumsum of nbits) and added into a zeroed
    (pay_words,) payload (the bit ranges are disjoint, so the sum is the
    OR; what falls past pay_words goes to a dump word) ->
    int32 bit patterns, ``merge_mb_strings``' placement."""
    n, w_cap = words.shape
    nb = nbits.to(_I64)
    offs = torch.cumsum(nb, 0) - nb
    sh = (offs & 31)[:, None]
    w0 = (offs >> 5)[:, None]
    used = ((nb + 31) >> 5).clamp(max=w_cap)
    w = words.to(_I64) & _MASK32
    j = torch.arange(w_cap, device=words.device)[None, :]
    valid = j < used[:, None]
    hi = torch.where(valid, w >> sh, 0)
    lo = torch.where(valid & (sh > 0), (w << (32 - sh)) & _MASK32, 0)
    out = torch.zeros(pay_words + 1, dtype=_I64, device=words.device)
    at = (w0 + j).clamp(max=pay_words)
    out.scatter_add_(0, at.reshape(-1), hi.reshape(-1))
    out.scatter_add_(0, (at + 1).clamp(max=pay_words).reshape(-1),
                     lo.reshape(-1))
    return _int32_bits(out[:pay_words])


def payload_words(n: int, n_words: int) -> int:
    """The payload's fixed size: every MB's n_words words and one more."""
    return n * n_words + 1


def pack_blob_plain(hv, hl, rv, rl, n_words: int, fields=()):
    """Plain twin of ``pack_blob_``: the header and residual grids packed
    per MB (``pack_tokens_plain`` on the two side by side) -> the blob
    (N, n_words + 1 + nf) of words, nbits and the nf (N,) ``fields``."""
    words, nbits = pack_tokens_plain(torch.cat([hv, rv], 1),
                                     torch.cat([hl, rl], 1), n_words)
    return torch.cat([words, nbits[:, None]]
                     + [f.to(_I32)[:, None] for f in fields], 1)


def place_blob_plain(blob, n_words: int):
    """Plain twin of ``place_``: ``place_plain`` of a blob's words and
    nbits into the (N * n_words + 1,) payload."""
    return place_plain(blob[:, :n_words], blob[:, n_words],
                       payload_words(blob.shape[0], n_words))


@functools.lru_cache(maxsize=1)
def _limits():
    """(max n_words, max slots a row, max fields, max MBs placed, MBs a
    sum of the placement) of the kernels, read once."""
    lib = library()
    return (lib.bitpack_max_words(), lib.bitpack_max_slots(),
            lib.bitpack_max_fields(), lib.bitplace_max_mbs(),
            lib.bitplace_sum_mbs())


def sum_words(n: int) -> int:
    """The placement's sums on the card: one word a block of MBs."""
    return -(-n // _limits()[4])


def max_words() -> int:
    """The largest n_words the kernel takes (its shared word buffer)."""
    return _limits()[0]


def work(n: int, s: int, n_words: int, nf: int = 0,
         used_words: int = 0) -> int:
    """Bytes of the packing and the placement on n MBs of s slots: vals
    and lens read once (8 bytes a slot), the fields read and the blob
    (n_words + 1 + nf words a row) written once, and the payload's used
    words (this call's data: ceil(total bits / 32)) written once."""
    return 8 * n * s + 4 * n * nf + 4 * n * (n_words + 1 + nf) \
        + 4 * used_words


def pack_blob_(hv, hl, rv, rl, n_words: int, fields=()):
    """Launch the packing kernel on CUDA tensors: header grid hv/hl (N, H)
    and residual grid rv/rl (N, R) int32 (R a multiple of 4, the residual
    rows 16-byte aligned), up to 4 (N,) int32 ``fields`` -> blob (N,
    n_words + 1 + nf) int32."""
    dev = hv.device
    if dev.type != "cuda" or hv.dim() != 2 or rv.dim() != 2:
        raise ValueError(f"bitpack: grids {tuple(hv.shape)} and "
                         f"{tuple(rv.shape)} on {dev}")
    (n, h), r = hv.shape, rv.shape[1]
    max_w, max_s, max_f, _, _ = _limits()
    if not 1 <= n_words <= max_w:
        raise ValueError(f"bitpack: n_words {n_words} outside 1..{max_w}")
    if h + r > max_s or r % 4 or len(fields) > max_f:
        raise ValueError(f"bitpack: {h} + {r} slots a row (at most {max_s}"
                         ", the residual grid's width a multiple of 4), "
                         f"{len(fields)} fields (at most {max_f})")
    check_tensors("bitpack", dev,
                  [("hv", hv, (n, h), _I32, False),
                   ("hl", hl, (n, h), _I32, False),
                   ("rv", rv, (n, r), _I32, True),
                   ("rl", rl, (n, r), _I32, True)]
                  + [(f"field {i}", f, (n,), _I32, False)
                     for i, f in enumerate(fields)])
    nf = len(fields)
    fp = [f.data_ptr() for f in fields] + [None] * (max_f - nf)
    blob = torch.empty((n, n_words + 1 + nf), dtype=_I32, device=dev)
    with torch.cuda.device(dev):
        err = library().bitpack_launch(
            hv.data_ptr(), hl.data_ptr(), h, rv.data_ptr(), rl.data_ptr(),
            r, *fp, nf, blob.data_ptr(), n_words, n,
            torch.cuda.current_stream(dev).cuda_stream)
    check(err, "bitpack")
    LAUNCHES["bitpack"] += 1
    return blob


def place_(blob, n_words: int):
    """Launch the placement on a CUDA blob (N, n_words + 1 + nf) int32,
    as ``pack_blob_`` writes it -> the payload (N * n_words + 1,) int32:
    sums of the nbits column by blocks of 256 MBs beside the payload's
    zeroing, then the MBs' words stored at their offsets."""
    dev = blob.device
    if dev.type != "cuda" or blob.dim() != 2:
        raise ValueError(f"bitplace: blob {tuple(blob.shape)} on {dev}")
    n, stride = blob.shape
    max_w, _, _, max_n, _ = _limits()
    if not 1 <= n_words <= min(max_w, stride - 1) or n > max_n:
        raise ValueError(f"bitplace: n_words {n_words} outside 1..{max_w} "
                         f"or past the blob's {stride} columns, or {n} "
                         f"MBs (at most {max_n})")
    check_tensors("bitplace", dev, [("blob", blob, (n, stride), _I32,
                                     False)])
    pay = payload_words(n, n_words)
    # one buffer: the payload, then the blocks' sums, which the returned
    # view keeps alive
    buf = torch.empty(pay + sum_words(n), dtype=_I32, device=dev)
    payload = buf[:pay]
    with torch.cuda.device(dev):
        err = library().bitplace_launch(
            blob.data_ptr(), stride, n_words, n, buf[pay:].data_ptr(),
            payload.data_ptr(), pay,
            torch.cuda.current_stream(dev).cuda_stream)
    check(err, "bitplace")
    LAUNCHES["bitpack"] += 1
    return payload


def pack_blob(hv, hl, rv, rl, n_words: int, fields=()):
    """The blob of a frame's header and residual slot grids: the kernel
    on CUDA tensors, the plain twin on CPU tensors."""
    if hv.device.type == "cpu":
        return pack_blob_plain(hv, hl, rv, rl, n_words, fields)
    if hv.device.type != "cuda":
        raise ValueError(f"pack_blob: no kernel for {hv.device}")
    return pack_blob_(hv, hl, rv, rl, n_words, fields)


def place(blob, n_words: int):
    """The slice payload of a blob (``pack_blob``'s): the kernel on a CUDA
    blob, the plain twin on a CPU blob."""
    if blob.device.type == "cpu":
        return place_blob_plain(blob, n_words)
    if blob.device.type != "cuda":
        raise ValueError(f"place: no kernel for {blob.device}")
    return place_(blob, n_words)


def pack_tokens(vals, lens, n_words: int):
    """(N, S) vals and lens on the CPU -> (words (N, n_words) int32, nbits
    (N,)), ``pack_tokens_plain``: the reference's ``pack_tokens``
    function.  The card packs whole blobs only (``pack_blob``)."""
    if vals.device.type != "cpu":
        raise ValueError(f"pack_tokens: no kernel for {vals.device}; the "
                         "card packs through pack_blob")
    return pack_tokens_plain(vals, lens, n_words)
