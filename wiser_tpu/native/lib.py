"""ctypes loader for the native codec library, with auto-build.

The shared library is compiled on first use (g++ -O3) and cached next to
the source. Every entry point has a pure-python/numpy fallback in the
modules that use it, so the package works without a toolchain — but the
native path is the production indexing/doc-store path, mirroring how the
reference keeps LittleIntPacker/libbloom/LZ4 native.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "wiser_native.cpp")
_SO = os.path.join(_HERE, "libwiser_native.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> bool:
    try:
        subprocess.run(
            ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", _SRC, "-o", _SO],
            check=True, capture_output=True, timeout=120,
        )
        return True
    except Exception:
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    """Returns the loaded library, building if needed; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_SO) or (
            os.path.exists(_SRC)
            and os.path.getmtime(_SRC) > os.path.getmtime(_SO)
        ):
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            return None

        u8p = ctypes.POINTER(ctypes.c_uint8)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        i64p = ctypes.POINTER(ctypes.c_int64)

        lib.wiser_murmur2.restype = ctypes.c_uint32
        lib.wiser_murmur2.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_uint32]
        lib.wiser_murmur2_batch.restype = None
        lib.wiser_murmur2_batch.argtypes = [u8p, i64p, i64p, ctypes.c_int64,
                                            ctypes.c_uint32, u32p]
        lib.wiser_murmur2_batch_seeded.restype = None
        lib.wiser_murmur2_batch_seeded.argtypes = [u8p, i64p, i64p,
                                                   ctypes.c_int64, u32p, u32p]
        lib.wiser_varint_encode.restype = ctypes.c_int64
        lib.wiser_varint_encode.argtypes = [u32p, ctypes.c_int64, u8p]
        lib.wiser_varint_decode.restype = ctypes.c_int64
        lib.wiser_varint_decode.argtypes = [u8p, ctypes.c_int64, ctypes.c_int64, u32p]
        lib.wiser_pack_blocks.restype = ctypes.c_int64
        lib.wiser_pack_blocks.argtypes = [u32p, u8p, ctypes.c_int64, u32p]
        lib.wiser_unpack_blocks.restype = ctypes.c_int64
        lib.wiser_unpack_blocks.argtypes = [u32p, u8p, ctypes.c_int64, u32p]
        lib.wiser_lz4_compress.restype = ctypes.c_int64
        lib.wiser_lz4_compress.argtypes = [u8p, ctypes.c_int64, u8p, ctypes.c_int64]
        lib.wiser_lz4_decompress.restype = ctypes.c_int64
        lib.wiser_lz4_decompress.argtypes = [u8p, ctypes.c_int64, u8p, ctypes.c_int64]
        lib.wiser_bloom_set_rows.restype = None
        lib.wiser_bloom_set_rows.argtypes = [u32p, u32p, i64p, ctypes.c_int64,
                                             ctypes.c_int, ctypes.c_uint32,
                                             ctypes.c_int, u32p]
        lib.wiser_linedoc_chunk.restype = ctypes.c_int64
        lib.wiser_linedoc_chunk.argtypes = [u8p, i64p, ctypes.c_int64, i64p,
                                            i64p, ctypes.c_int64, ctypes.c_int,
                                            u8p, ctypes.c_int64]
        _lib = lib
        return _lib


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _u32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


def _i64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def available() -> bool:
    return get_lib() is not None


# -- high-level wrappers ---------------------------------------------------


def murmur2_batch_seeded(blob: bytes, starts: np.ndarray, ends: np.ndarray,
                         seeds) -> np.ndarray:
    """Batch murmur2 of keys blob[starts[i]:ends[i]]. seeds may be None
    (uses the libbloom MURMUR_SEED for every key) or a uint32 array of
    per-key seeds (the double-hash second pass)."""
    from wiser_tpu.index.bloom import MURMUR_SEED

    n = len(starts)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    ends = np.ascontiguousarray(ends, dtype=np.int64)
    out = np.empty(n, dtype=np.uint32)
    lib = get_lib()
    if lib is None:
        from wiser_tpu.index.bloom import murmur2 as py_murmur2
        for i in range(n):
            seed = MURMUR_SEED if seeds is None else int(seeds[i])
            out[i] = py_murmur2(blob[starts[i]:ends[i]], seed)
        return out
    src = np.frombuffer(blob, dtype=np.uint8)
    if seeds is None:
        lib.wiser_murmur2_batch(_u8(src), _i64(starts), _i64(ends), n,
                                ctypes.c_uint32(MURMUR_SEED), _u32(out))
    else:
        seeds = np.ascontiguousarray(seeds, dtype=np.uint32)
        lib.wiser_murmur2_batch_seeded(_u8(src), _i64(starts), _i64(ends), n,
                                       _u32(seeds), _u32(out))
    return out


def murmur2(key: bytes, seed: int) -> int:
    lib = get_lib()
    if lib is None:
        from wiser_tpu.index.bloom import murmur2 as py_murmur2
        return py_murmur2(key, seed)
    return int(lib.wiser_murmur2(key, len(key), ctypes.c_uint32(seed & 0xFFFFFFFF)))


def lz4_compress(data: bytes) -> bytes:
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native lib unavailable")
    src = np.frombuffer(data, dtype=np.uint8)
    cap = len(data) + len(data) // 255 + 64
    dst = np.empty(cap, dtype=np.uint8)
    n = lib.wiser_lz4_compress(_u8(src), len(data), _u8(dst), cap)
    if n < 0:
        raise RuntimeError("lz4 compress failed")
    return dst[:n].tobytes()


def lz4_decompress(data: bytes, out_len: int) -> bytes:
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native lib unavailable")
    src = np.frombuffer(data, dtype=np.uint8)
    dst = np.empty(max(out_len, 1), dtype=np.uint8)
    n = lib.wiser_lz4_decompress(_u8(src), len(data), _u8(dst), out_len)
    if n != out_len:
        raise RuntimeError("lz4 decompress failed")
    return dst[:out_len].tobytes()


def linedoc_chunk(vocab_blob: np.ndarray, vocab_offs: np.ndarray,
                  ids: np.ndarray, bounds: np.ndarray,
                  with_blooms: bool) -> Optional[bytes]:
    """Assemble one chunk of canonical linedoc rows (data/scale_corpus
    layout) from flat token ids; returns the row bytes (each row
    newline-terminated) or None when the native lib is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    ids = np.ascontiguousarray(ids, dtype=np.int64)
    bounds = np.ascontiguousarray(bounds, dtype=np.int64)
    vocab_offs = np.ascontiguousarray(vocab_offs, dtype=np.int64)
    n_vocab = len(vocab_offs) - 1
    cap = int(len(ids)) * 140 + int(len(bounds)) * 64 + 4096
    while True:
        out = np.empty(cap, dtype=np.uint8)
        n = lib.wiser_linedoc_chunk(
            _u8(vocab_blob), _i64(vocab_offs), n_vocab, _i64(ids),
            _i64(bounds), len(bounds) - 1, 1 if with_blooms else 0,
            _u8(out), cap)
        if n >= 0:
            return out[:n].tobytes()
        cap *= 2


def pack_blocks(vals: np.ndarray, widths: np.ndarray) -> np.ndarray:
    """vals: uint32[(n_blocks*128)]; widths: uint8[n_blocks] -> packed words."""
    lib = get_lib()
    vals = np.ascontiguousarray(vals, dtype=np.uint32)
    widths = np.ascontiguousarray(widths, dtype=np.uint8)
    nb = len(widths)
    out = np.empty(int(4 * widths.astype(np.int64).sum()), dtype=np.uint32)
    if lib is None:
        from wiser_tpu.codecs import pack_block
        p = 0
        for b in range(nb):
            w = int(widths[b])
            out[p : p + 4 * w] = pack_block(vals[b * 128 : (b + 1) * 128], w)
            p += 4 * w
        return out
    lib.wiser_pack_blocks(_u32(vals), _u8(widths), nb, _u32(out))
    return out


def bloom_set_rows(a: np.ndarray, b: np.ndarray, row: np.ndarray,
                   n_hashes: int, bits: int, rows: np.ndarray) -> bool:
    """OR each key's probe bits into rows[row[i]] (uint32 (P, n_words),
    C-contiguous, modified in place). Returns False without the library."""
    lib = get_lib()
    if lib is None:
        return False
    if rows.dtype != np.uint32 or not rows.flags.c_contiguous:
        raise ValueError("rows must be a C-contiguous uint32 array")
    a = np.ascontiguousarray(a, dtype=np.uint32)
    b = np.ascontiguousarray(b, dtype=np.uint32)
    row = np.ascontiguousarray(row, dtype=np.int64)
    if not (len(a) == len(b) == len(row)):
        raise ValueError("a, b and row must have one entry per key")
    if len(row) and (row.min() < 0 or row.max() >= rows.shape[0]):
        raise ValueError("row index out of range")
    lib.wiser_bloom_set_rows(_u32(a), _u32(b), _i64(row), len(row),
                             int(n_hashes), int(bits), rows.shape[1],
                             _u32(rows))
    return True


def unpack_blocks(words: np.ndarray, widths: np.ndarray) -> np.ndarray:
    lib = get_lib()
    words = np.ascontiguousarray(words, dtype=np.uint32)
    widths = np.ascontiguousarray(widths, dtype=np.uint8)
    nb = len(widths)
    out = np.empty(nb * 128, dtype=np.uint32)
    if lib is None:
        from wiser_tpu.codecs import unpack_block
        p = 0
        for b in range(nb):
            w = int(widths[b])
            out[b * 128 : (b + 1) * 128] = unpack_block(words[p : p + 4 * w], w)
            p += 4 * w
        return out
    lib.wiser_unpack_blocks(_u32(words), _u8(widths), nb, _u32(out))
    return out


def varint_encode_array(vals: np.ndarray) -> bytes:
    lib = get_lib()
    vals = np.ascontiguousarray(vals, dtype=np.uint32)
    if lib is None:
        from wiser_tpu.codecs import varint_encode
        buf = bytearray()
        for v in vals:
            varint_encode(int(v), buf)
        return bytes(buf)
    out = np.empty(5 * len(vals) + 8, dtype=np.uint8)
    n = lib.wiser_varint_encode(_u32(vals), len(vals), _u8(out))
    return out[:n].tobytes()


def varint_decode_array(buf: bytes, n: int) -> np.ndarray:
    lib = get_lib()
    if lib is None:
        from wiser_tpu.codecs import varint_decode
        out, pos = np.empty(n, dtype=np.uint32), 0
        for i in range(n):
            v, used = varint_decode(buf, pos)
            out[i] = v
            pos += used
        return out
    src = np.frombuffer(buf, dtype=np.uint8)
    out = np.empty(n, dtype=np.uint32)
    used = lib.wiser_varint_decode(_u8(src), len(buf), n, _u32(out))
    if used < 0:
        raise ValueError("truncated varint stream")
    return out
