"""tests/test_adversarial_ties.py's tie-heavy oracle parity, run on an
NVIDIA GPU, whose lax.top_k tie order the guards must not depend on.

`python chip_smoke.py` runs every `gpu`-marked test on the card; on any
other backend the tests here skip.
"""

import pytest

from test_adversarial_ties import (  # noqa: F401  (collected from here)
    corpus,
    test_margin_stress_bit_parity,
    test_strict_parity_margin_zero,
)

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module", autouse=True)
def _on_gpu():
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (run: python chip_smoke.py)")
