"""plasticinelab_tpu: differentiable soft-body manipulation benchmark — a
JAX/XLA rebuild of PlasticineLab.

Importing the package wires JAX's persistent compilation cache: into
$JAX_COMPILATION_CACHE_DIR when that is set (JAX reads it itself), and
otherwise into <checkout>/.jaxcache (gitignored). A fixed path matters: the
path is part of the cache key, and the 950-substep trajectory gradient is
one large program, so every entry point — not just the test suite — should
hit the cache.
"""
import os as _os

import jax as _jax

if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update("jax_compilation_cache_dir", _os.path.join(
        _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
        ".jaxcache"))
_jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
_jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
