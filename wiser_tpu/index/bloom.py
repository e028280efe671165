"""Bloom filters with libbloom-compatible parameters and probes.

reference: libbloom/bloom.c (bloom_init/bloom_check, double hashing
x_i = (a + i*b) mod bits with a = murmur2(key, 0x9747b28c),
b = murmur2(key, a); bloom.c:48-75,142-176) and
libbloom/murmur2/MurmurHash2.c (MurmurHash2 by Austin Appleby).

Accelerator-first redesign: filters are stored *columnar* — one
fixed-size row of uint32 words per (term, doc) posting, so a batch of bloom probes is a
gather of filter rows + a bitwise AND against per-query probe masks. The
probe *bit positions* depend only on the probed key string and the filter
geometry, so the host computes them once per query (11 small ints for the
default config) and the device tests them against thousands of candidate
filters at once (the CheckBloom / bi-bloom pre-check analog,
query_processing.h:784-807).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

MURMUR_SEED = 0x9747B28C  # bloom.c:57

_U32 = 0xFFFFFFFF


def murmur2(key: bytes, seed: int) -> int:
    """MurmurHash2 (32-bit, little-endian) — matches
    libbloom/murmur2/MurmurHash2.c exactly for little-endian machines."""
    m = 0x5BD1E995
    r = 24
    length = len(key)
    h = (seed ^ length) & _U32
    i = 0
    while length >= 4:
        k = int.from_bytes(key[i : i + 4], "little")
        k = (k * m) & _U32
        k ^= k >> r
        k = (k * m) & _U32
        h = (h * m) & _U32
        h ^= k
        i += 4
        length -= 4
    if length == 3:
        h ^= key[i + 2] << 16
    if length >= 2:
        h ^= key[i + 1] << 8
    if length >= 1:
        h ^= key[i]
        h = (h * m) & _U32
    h ^= h >> 13
    h = (h * m) & _U32
    h ^= h >> 15
    return h


@dataclass(frozen=True)
class BloomConfig:
    """libbloom sizing (bloom.c:83-117). Defaults match the reference's
    indexer (tools/indexer.py:43-44: expected_entries=5, ratio=0.0009)."""

    expected_entries: int = 5
    error_ratio: float = 0.0009

    @property
    def bpe(self) -> float:
        return -(math.log(self.error_ratio) / 0.480453013918201)  # ln(2)^2

    @property
    def bits(self) -> int:
        return int(self.expected_entries * self.bpe)

    @property
    def n_bytes(self) -> int:
        bits = self.bits
        return bits // 8 + (1 if bits % 8 else 0)

    @property
    def n_hashes(self) -> int:
        return int(math.ceil(0.693147180559945 * self.bpe))  # ln(2)

    @property
    def n_words(self) -> int:
        """uint32 words per filter row in the columnar store."""
        return (self.n_bytes + 3) // 4

    # -- host-side key hashing -------------------------------------------

    def probe_bits(self, key: str) -> np.ndarray:
        """Bit positions probed for `key` (bloom.c:57-66): int32[n_hashes]."""
        data = key.encode("utf-8")
        a = murmur2(data, MURMUR_SEED)
        b = murmur2(data, a)
        i = np.arange(self.n_hashes, dtype=np.uint64)
        # libbloom does `x = (a + i*b) % bits` in 32-bit unsigned arithmetic
        # (bloom.c:59-64): a+i*b wraps mod 2^32 BEFORE the modulo. Match it
        # so filters interop with reference-serialized bit arrays.
        x = ((np.uint64(a) + i * np.uint64(b)) & np.uint64(_U32)) % np.uint64(
            self.bits)
        return x.astype(np.int32)

    def probe_word_masks(self, key: str) -> tuple[np.ndarray, np.ndarray]:
        """(word_idx int32[n_hashes], mask uint32[n_hashes]) for columnar
        probing: present iff (filter_words[word_idx] & mask) == mask
        for every probe. Bit b of the byte array maps to byte b>>3, bit
        b%8 (bloom.c:31-45); with little-endian uint32 packing, byte k of
        word w holds bits [8k, 8k+8)."""
        bits = self.probe_bits(key).astype(np.int64)
        word_idx = (bits // 32).astype(np.int32)
        mask = (np.uint32(1) << (bits % 32).astype(np.uint32)).astype(np.uint32)
        return word_idx, mask

    def probe_mask_folded(self, key: str) -> np.uint32:
        """Single-word folded probe mask for the sparse device bloom
        layout: original bit x maps to bit x%32 of the OR-fold of the
        row's words (word w's bit b is original bit 32w+b, so OR-ing
        words preserves residues mod 32). Superset semantics — a key
        present in the exact row always passes the folded check, so the
        fold can only ADMIT more lanes (slightly higher false-positive
        rate), never prune a true phrase match."""
        bits = self.probe_bits(key).astype(np.int64)
        m = np.uint32(0)
        for b in (bits % 32).tolist():
            m |= np.uint32(1) << np.uint32(b)
        return m

    # -- filter construction ---------------------------------------------

    def build_filter_words(self, keys) -> np.ndarray:
        """Build one filter row: uint32[n_words] with all keys added
        (bloom_add semantics)."""
        words = np.zeros(self.n_words, dtype=np.uint32)
        for key in keys:
            w, m = self.probe_word_masks(key)
            np.bitwise_or.at(words, w, m)
        return words

    def check(self, words: np.ndarray, key: str) -> bool:
        """bloom_check over a columnar row. An all-zero row (no filter
        stored) is never 'present', matching BloomFilter::Check's empty
        case (bloom_filter.h:83-85)."""
        w, m = self.probe_word_masks(key)
        return bool(np.all((words[w] & m) == m))

    def words_from_bytes(self, raw: bytes) -> np.ndarray:
        """Convert a libbloom byte array to the columnar word row."""
        buf = raw.ljust(self.n_words * 4, b"\0")
        return np.frombuffer(buf, dtype="<u4").copy()
