"""A device error raised inside a dispatch propagates out of search_batch
at once: it is neither retried nor answered by a silent host fallback."""

import jax
import pytest

from wiser_tpu.data.synth import synth_docinfos
from wiser_tpu.engine import kernels as K
from wiser_tpu.engine.device import TpuEngine
from wiser_tpu.engine.staged import StagedEngine
from wiser_tpu.index.builder import build_index
from wiser_tpu.types import SearchQuery


class _FaultyOutput:
    """Stands in for a device result whose fetch fails on the device."""

    def __array__(self, *a, **k):
        raise jax.errors.JaxRuntimeError("INTERNAL: injected device fault")


def _faulty_factory(calls):
    def make(*a, **k):
        def kern(*args):
            calls.append(args)
            return _FaultyOutput()

        return kern

    return make


@pytest.fixture(scope="module")
def packed():
    return build_index(synth_docinfos(400, 60, 30, seed=4))[0]


@pytest.fixture
def faulty_kernels(monkeypatch):
    calls = []
    for name in ("make_search_kernel", "make_windowed_search_kernel"):
        monkeypatch.setattr(K, name, _faulty_factory(calls))
    return calls


def test_tpu_engine_error_propagates(packed, faulty_kernels):
    eng = TpuEngine(packed, single_term_depth=0, dense_budget_bytes=0)
    with pytest.raises(jax.errors.JaxRuntimeError, match="injected"):
        eng.search_batch([SearchQuery(["t0", "t1"], n_results=5)])
    assert len(faulty_kernels) == 1


def test_staged_cold_error_propagates(packed, faulty_kernels):
    eng = StagedEngine(packed, hbm_budget_bytes=1)
    eng.COLD_COMPUTE = "device"  # cold runs staged to the device
    q = SearchQuery(["t0", "t1"], n_results=5)
    assert not all(eng.hot_mask[packed.lookup(t)] for t in q.terms)
    with pytest.raises(jax.errors.JaxRuntimeError, match="injected"):
        eng.search_batch([q])
    assert len(faulty_kernels) == 1
