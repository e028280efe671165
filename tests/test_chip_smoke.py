"""chip_smoke.py measures nothing off the card: its device check refuses
any backend but an NVIDIA GPU, and the script then prints no result."""

import json
import os
import subprocess
import sys

import pytest

import chip_smoke

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_device_check_refuses_cpu():
    import jax

    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(SystemExit, match="needs an NVIDIA GPU"):
        chip_smoke.require_gpu(jax.devices())
    with pytest.raises(SystemExit, match="needs an NVIDIA GPU"):
        chip_smoke.require_gpu([])


def test_script_fails_without_gpu(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path))
    p = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                       capture_output=True, text=True, env=env, timeout=300)
    assert p.returncode != 0
    assert "needs an NVIDIA GPU" in p.stderr
    for line in p.stdout.splitlines():
        assert not line.startswith("{") or not json.loads(line).get("ok")
