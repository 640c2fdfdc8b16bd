"""Test configuration: run everything on a virtual 8-device CPU mesh.

Must set env vars before the first jax import anywhere in the test process.
x64 is enabled so float64 golden tests against the reference physics (the
reference simulates in float64, plb/engine/mpm_simulator.py:8) are meaningful;
library code always passes explicit dtypes and works in both modes.

With JAX_PLATFORMS naming the GPU (`JAX_PLATFORMS=cuda pytest -m gpu`, see
README.md) the platform (and float32 default) is left alone so the `gpu`-marked
tests reach the card as chip_smoke.py does. The compile cache follows the package's rule
(plasticinelab_tpu/__init__.py): $JAX_COMPILATION_CACHE_DIR, else
<checkout>/.jaxcache.
"""
import os

_on_gpu = any(p in os.environ.get("JAX_PLATFORMS", "")
              for p in ("cuda", "gpu"))

flags = os.environ.get("XLA_FLAGS", "")
if not _on_gpu and "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

import plasticinelab_tpu  # noqa: E402,F401  (wires the compile cache)

if not _on_gpu:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
