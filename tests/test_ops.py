"""Device decode kernel (XLA) and utils."""

import numpy as np
import pytest

from wiser_tpu.codecs import pack_block
from wiser_tpu.ops.unpack import (
    delta_decode_docs,
    pack_doc_blocks,
    unpack_blocks_xla,
    unpack_doc_blocks,
)


class TestUnpackXla:
    @pytest.mark.parametrize("width", [1, 3, 5, 13, 17, 21, 32])
    def test_matches_host_codec(self, width):
        import jax.numpy as jnp

        rng = np.random.default_rng(width)
        G = 16
        vals = rng.integers(0, 2 ** min(width, 31), size=(G, 128),
                            dtype=np.uint64).astype(np.uint32)
        words = np.stack([pack_block(vals[g], width) for g in range(G)])
        out = np.asarray(unpack_blocks_xla(jnp.asarray(words), width))
        np.testing.assert_array_equal(out, vals)


class TestDocColumnRoundtrip:
    def test_roundtrip_with_sentinels(self):
        from wiser_tpu.data.synth import synth_docinfos
        from wiser_tpu.index.builder import build_index
        from wiser_tpu.index.format import SENTINEL_DOC

        packed, _ = build_index(synth_docinfos(300, 80, 25, seed=9))
        comp = pack_doc_blocks(packed.postings_doc)
        decoded = unpack_doc_blocks(comp)
        real = packed.postings_doc != SENTINEL_DOC
        np.testing.assert_array_equal(decoded[real], packed.postings_doc[real])
        # compression: width-bucketed deltas beat raw int32
        bits = sum(w.size * 32 for _, (s, w) in comp["groups"].items())
        assert bits < packed.n_postings * 32

    def test_delta_decode(self):
        import jax.numpy as jnp

        deltas = jnp.asarray(np.array([[0, 2, 0, 5]] , dtype=np.uint32))
        first = jnp.asarray(np.array([100], dtype=np.int32))
        # lane deltas store delta-1: decoded = 100, 103, 104, 110
        out = np.asarray(delta_decode_docs(deltas, first))
        np.testing.assert_array_equal(out, [[100, 103, 104, 110]])


class TestUtils:
    def test_phase_timer(self):
        from wiser_tpu.utils import PhaseTimer

        pt = PhaseTimer()
        with pt.phase("a"):
            pass
        with pt.phase("a"):
            pass
        with pt.phase("b"):
            pass
        rep = pt.report()
        assert "a\t" in rep and "b\t" in rep
        assert pt.counts["a"] == 2

    def test_compile_cache_dir(self, tmp_path, monkeypatch):
        """$JAX_COMPILATION_CACHE_DIR when set, else one fixed path inside
        the checkout (the path is part of the cache key)."""
        import os

        import jax

        from wiser_tpu import utils

        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        default = os.path.join(root, ".jax_cache")
        assert utils.DEFAULT_COMPILE_CACHE_DIR == default
        old = (jax.config.jax_compilation_cache_dir,
               jax.config.jax_persistent_cache_min_compile_time_secs)
        try:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
            assert utils.enable_compile_cache() == str(tmp_path)
            assert jax.config.jax_compilation_cache_dir == str(tmp_path)
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
            assert utils.enable_compile_cache() == default
            assert jax.config.jax_compilation_cache_dir == default
        finally:
            jax.config.update("jax_compilation_cache_dir", old[0])
            jax.config.update("jax_persistent_cache_min_compile_time_secs",
                              old[1])

    def test_result_table(self):
        from wiser_tpu.utils import ResultTable

        t = ResultTable()
        t.add_row(engine="tpu", qps=100)
        t.add_row(engine="oracle", qps=1, extra="x")
        s = t.to_str()
        assert s.splitlines()[0] == "engine\tqps\textra"
        assert "NA" in s.splitlines()[1]


class TestRunExp:
    def test_quick_matrix(self, tmp_path):
        from wiser_tpu.bench.run_exp import default_matrix, run_treatment

        ts = default_matrix(quick=True)
        assert len(ts) == 2
        r = run_treatment(ts[0])
        assert r.qps > 0
        assert r.treatment["name"] == "quick_mix"
