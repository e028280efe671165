"""Primitive codecs: lossy doc-length code, varint, delta/bit-packing.

These are the L0 primitives of the reference (compression.h, utils.h,
packed_value.h) re-expressed as vectorized NumPy for the host indexing path.
Device-side decode of bit-packed blocks lives in wiser_tpu/ops/unpack.py.

The bit layout choices here are *ours* (array-structured, word-aligned for
device gathers); only the externally observable semantics — the lossy length
code values and delta+pack losslessness — match the reference.
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# Lossy 1-byte doc-length code (reference: utils.h:301-330,
# UintToChar4/Char4ToUint — "float-like" 3-bit mantissa + 5-bit shift).
# ---------------------------------------------------------------------------


def uint_to_char4(val: int) -> int:
    """Encode a non-negative int into the lossy 1-byte code.

    reference: utils.h:301-315. val must be < 0x80000000.
    """
    v = int(val)
    if v < 0x08:
        return v & 0xFF
    num_of_bits = v.bit_length()
    shift = num_of_bits - 4
    encoded = (v >> shift) & 0x07
    encoded |= (shift + 1) << 3
    return encoded


def char4_to_uint(code: int) -> int:
    """Decode the lossy 1-byte code (reference: utils.h:317-330)."""
    c = int(code) & 0xFF
    bits = c & 0x07
    shift = (c >> 3) - 1
    if shift == -1:
        return bits
    return (bits | 0x08) << shift


# Precomputed decode table for all 256 codes — the analog of the decode half
# of Bm25Similarity::BuildCache (scoring.h:85-90).
CHAR4_DECODE_TABLE = np.array([char4_to_uint(c) for c in range(256)], dtype=np.int64)


def uint_to_char4_np(vals: np.ndarray) -> np.ndarray:
    """Vectorized uint_to_char4 over an int array -> uint8 codes."""
    v = np.asarray(vals, dtype=np.int64)
    nbits = np.zeros_like(v)
    tmp = v.copy()
    # bit_length via repeated shift count (v < 2**31 so <= 31 iterations);
    # vectorized with log2-free integer ops.
    for _ in range(31):
        nz = tmp > 0
        if not nz.any():
            break
        nbits[nz] += 1
        tmp[nz] >>= 1
    shift = nbits - 4
    big = v >= 0x08
    enc_big = ((v >> np.maximum(shift, 0)) & 0x07) | ((shift + 1) << 3)
    out = np.where(big, enc_big, v & 0x07)
    return out.astype(np.uint8)


# ---------------------------------------------------------------------------
# Varint (LEB128) — reference: compression.h:6-131, utils.h:230-260.
# Used for host-side serialization of variable metadata, not on device.
# ---------------------------------------------------------------------------


def varint_encode(value: int, out: bytearray) -> None:
    v = int(value)
    if v < 0:
        raise ValueError("varint requires non-negative values")
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def varint_decode(buf: bytes, offset: int) -> tuple[int, int]:
    """Return (value, bytes_consumed) starting at offset."""
    result = 0
    shift = 0
    pos = offset
    while True:
        b = buf[pos]
        result |= (b & 0x7F) << shift
        pos += 1
        if not (b & 0x80):
            return result, pos - offset
        shift += 7


# ---------------------------------------------------------------------------
# Delta + fixed-width bit packing of posting blocks.
#
# The reference packs 128-int blocks at the narrowest bit width via
# LittleIntPacker (packed_value.h:87-274). We keep the 128-value block and
# the per-block width, but lay words out so a device kernel can unpack with
# aligned vector loads: each block is `width` consecutive uint32 lanes of a
# (n_blocks, 32*?) ... simplest robust layout: ceil(128*width/32) uint32
# words per block, bits written little-endian within the block.
# ---------------------------------------------------------------------------

BLOCK = 128


def bits_needed(vals: np.ndarray) -> int:
    m = int(vals.max(initial=0))
    return max(1, m.bit_length())


def pack_block(vals: np.ndarray, width: int) -> np.ndarray:
    """Pack 128 uint32 values at `width` bits into 4*width uint32 words.

    Layout: value i occupies bits [i*width, (i+1)*width) of the block's
    little-endian bit stream. 128*width bits = 4*width uint32 words exactly.
    """
    assert len(vals) == BLOCK
    v = np.asarray(vals, dtype=np.uint64)
    assert width >= 1 and int(v.max(initial=0)) < (1 << width)
    nwords = 4 * width
    words = np.zeros(nwords, dtype=np.uint64)
    bitpos = np.arange(BLOCK, dtype=np.uint64) * np.uint64(width)
    word_idx = (bitpos >> np.uint64(5)).astype(np.int64)
    bit_off = (bitpos & np.uint64(31)).astype(np.uint64)
    lo = (v << bit_off) & np.uint64(0xFFFFFFFF)
    hi = v >> (np.uint64(32) - bit_off)
    # bit_off == 0 -> hi must be 0 (shift by 32 is UB territory; mask it)
    hi = np.where(bit_off == 0, np.uint64(0), hi)
    np.bitwise_or.at(words, word_idx, lo)
    spill = word_idx + 1 < nwords
    np.bitwise_or.at(words, word_idx[spill] + 1, hi[spill])
    return words.astype(np.uint32)


def unpack_block(words: np.ndarray, width: int) -> np.ndarray:
    """Inverse of pack_block -> 128 uint32 values."""
    w = np.asarray(words, dtype=np.uint64)
    bitpos = np.arange(BLOCK, dtype=np.uint64) * np.uint64(width)
    word_idx = (bitpos >> np.uint64(5)).astype(np.int64)
    bit_off = (bitpos & np.uint64(31)).astype(np.uint64)
    lo = w[word_idx] >> bit_off
    nxt = np.where(word_idx + 1 < len(w), w[np.minimum(word_idx + 1, len(w) - 1)], 0)
    hi = np.where(bit_off == 0, np.uint64(0), nxt << (np.uint64(32) - bit_off))
    vals = (lo | hi) & ((np.uint64(1) << np.uint64(width)) - np.uint64(1))
    return vals.astype(np.uint32)


def delta_encode(sorted_vals: np.ndarray, first_delta_from: int = 0) -> np.ndarray:
    """d[0] = v[0]-first_delta_from, d[i] = v[i]-v[i-1]. Strictly ascending
    doc ids give deltas >= 1; we store delta-1 for doc ids at pack time to
    shave a bit (handled by callers)."""
    v = np.asarray(sorted_vals, dtype=np.int64)
    d = np.empty_like(v)
    if len(v):
        d[0] = v[0] - first_delta_from
        d[1:] = v[1:] - v[:-1]
    return d


def delta_decode(deltas: np.ndarray, first_delta_from: int = 0) -> np.ndarray:
    d = np.asarray(deltas, dtype=np.int64)
    return np.cumsum(d) + first_delta_from
