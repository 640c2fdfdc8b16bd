"""Checks that need the card: the float64-oracle comparison and the
GPU-vs-CPU gradient of chip_smoke.py, as pytest cases. Without a GPU they
skip; on the card run them with

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/test_gpu.py
"""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.gpu


@pytest.fixture()
def smoke():
    import jax

    try:
        jax.devices("gpu")
    except RuntimeError:
        pytest.skip("no GPU backend: run on the card with "
                    "JAX_PLATFORMS=cuda,cpu pytest -m gpu")
    sys.path.insert(0, ROOT)
    import chip_smoke

    return chip_smoke


def test_move_v1_matches_float64_oracle_on_gpu(smoke):
    out = smoke.phase_oracle({})
    assert out["ok"], out


def test_gradient_gpu_matches_cpu(smoke):
    out = smoke.phase_gradient({})
    assert out["finite"] and out["nonzero"], out
    cross = out["cpu_vs_gpu"]
    assert cross["grad_rel_err"] <= cross["tolerance"], cross
