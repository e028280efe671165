"""tests/test_engine_parity.py's oracle parity suites, run on an NVIDIA GPU.

`python chip_smoke.py` runs every `gpu`-marked test on the card; on any
other backend the tests here skip.
"""

import pytest

from test_engine_parity import (  # noqa: F401  (collected from here)
    TestConjunctive,
    TestPhrase,
    TestSingleTerm,
    TestSnippets,
    TestTies,
    corpus,
)

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module", autouse=True)
def _on_gpu():
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (run: python chip_smoke.py)")
