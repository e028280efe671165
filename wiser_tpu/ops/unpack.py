"""Device-side decode of bit-packed posting blocks — the LittleIntPacker
(turbounpack32) analog, SURVEY.md §2's "#1 native kernel to replace".

Storage format (matches codecs.pack_block / native wiser_pack128): each
128-value block is packed at a fixed width w; value i occupies bits
[i*w, (i+1)*w) of a little-endian stream of 4*w uint32 words. Doc ids are
stored as block-local deltas (delta-1 for strictly-ascending ids) against
a per-block first-doc column, so a block decodes independently — exactly
the reference's pack + skip-entry structure (packed_value.h:87-274,
flash_containers.h:236).

Because the width is static per kernel, every value's (word index, bit
offset) pair is a compile-time constant: the unpack is expressed as two
constant-index gathers + shifts + mask — no data-dependent indexing, so
XLA fuses it into one elementwise kernel (unpack_blocks_xla).
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

BLOCK = 128


def _static_layout(width: int):
    """(word_idx[128], bit_off[128], needs_hi[128]) as numpy constants."""
    bitpos = np.arange(BLOCK, dtype=np.int64) * width
    word_idx = (bitpos >> 5).astype(np.int32)
    bit_off = (bitpos & 31).astype(np.int32)
    needs_hi = (bit_off + width > 32).astype(np.uint32)
    return word_idx, bit_off, needs_hi


def _unpack_math(words, width: int):
    """words: (..., 4*width) uint32 -> (..., 128) uint32. Constant-index
    gathers only."""
    word_idx, bit_off, needs_hi = _static_layout(width)
    mask = np.uint32(0xFFFFFFFF) if width == 32 else np.uint32((1 << width) - 1)
    lo_w = jnp.take(words, jnp.asarray(word_idx), axis=-1)
    hi_idx = np.minimum(word_idx + 1, 4 * width - 1)
    hi_w = jnp.take(words, jnp.asarray(hi_idx), axis=-1)
    off = jnp.asarray(bit_off, dtype=jnp.uint32)
    lo = lo_w >> off
    # (32 - off) can be 32 when off == 0: mask those lanes out instead
    hi_shift = jnp.asarray((32 - bit_off) % 32, dtype=jnp.uint32)
    hi = jnp.where(jnp.asarray(needs_hi, dtype=bool), hi_w << hi_shift, jnp.uint32(0))
    return (lo | hi) & mask


@lru_cache(maxsize=40)
def _xla_unpack(width: int):
    @jax.jit
    def f(words):  # (G, 4*width) uint32
        return _unpack_math(words, width)

    return f


def unpack_blocks_xla(words: jnp.ndarray, width: int) -> jnp.ndarray:
    """(G, 4*width) uint32 -> (G, 128) uint32."""
    return _xla_unpack(width)(words)


def delta_decode_docs(deltas_u32: jnp.ndarray, block_first: jnp.ndarray) -> jnp.ndarray:
    """(G, 128) packed deltas (delta-1 of ascending ids, first lane is the
    delta from block_first... lane 0 stores 0) + (G,) first ids ->
    (G, 128) absolute int32 doc ids."""
    d = deltas_u32.astype(jnp.int32)
    inc = jnp.cumsum(d + 1, axis=1) - (d[:, :1] + 1)
    return block_first[:, None] + inc


# -- host-side packing for the compressed posting column -------------------


def doc_block_deltas(postings_doc: np.ndarray):
    """(G, 128) block-local delta-1 values + (G,) block-first ids for a
    128-aligned, sentinel-padded doc column. Sentinel lanes carry the
    previous real id (delta 0) so they pack at zero cost; consumers mask
    by run length as usual."""
    from wiser_tpu.index.format import SENTINEL_DOC

    P = len(postings_doc)
    assert P % BLOCK == 0
    blocks = postings_doc.reshape(-1, BLOCK).astype(np.int64)
    real = blocks != SENTINEL_DOC
    carried = np.where(real, blocks, 0)
    np.maximum.accumulate(carried, axis=1, out=carried)
    first = carried[:, 0]
    deltas = np.diff(carried, axis=1, prepend=carried[:, :1])
    deltas = np.where(deltas > 0, deltas - 1, 0).astype(np.uint32)
    return deltas, first.astype(np.int32)


def doc_block_widths(postings_doc: np.ndarray) -> np.ndarray:
    """(G,) uint8 per-128-block pack width (bits) of the delta stream."""
    deltas, _ = doc_block_deltas(postings_doc)
    return np.maximum(
        1,
        np.ceil(np.log2(deltas.max(axis=1).astype(np.float64) + 1.0)),
    ).astype(np.uint8)


def pack_doc_blocks(postings_doc: np.ndarray) -> dict:
    """Pack 128-aligned doc-id columns (sentinel-padded, as produced by the
    index builder) into width-bucketed delta blocks. Returns
    {width -> (block_ids int32[gw], words uint32[gw, 4*width])} plus the
    per-block first-doc column. Sentinel lanes pack as delta 0 (decoded
    values then repeat the previous id; consumers mask by df as usual)."""
    from wiser_tpu.native import lib as native

    deltas, first = doc_block_deltas(postings_doc)

    widths = np.maximum(
        1,
        np.ceil(np.log2(deltas.max(axis=1).astype(np.float64) + 1.0)),
    ).astype(np.uint8)
    out = {}
    for w in np.unique(widths):
        sel = np.nonzero(widths == w)[0].astype(np.int32)
        vals = deltas[sel].reshape(-1)
        words = native.pack_blocks(vals, np.full(len(sel), w, dtype=np.uint8))
        out[int(w)] = (sel, words.reshape(len(sel), 4 * int(w)))
    return {"groups": out, "block_first": first.astype(np.int32),
            "widths": widths}


def unpack_doc_blocks(packed: dict) -> np.ndarray:
    """Inverse of pack_doc_blocks -> int32[G*128] doc column (sentinel
    lanes hold the carried previous id, NOT the sentinel)."""
    G = len(packed["block_first"])
    out = np.zeros((G, BLOCK), dtype=np.int32)
    for w, (sel, words) in packed["groups"].items():
        vals = unpack_blocks_xla(jnp.asarray(words), w)
        firsts = jnp.asarray(packed["block_first"][sel])
        out[sel] = np.asarray(delta_decode_docs(vals, firsts))
    return out.reshape(-1)
