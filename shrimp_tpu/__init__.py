"""shrimp-tpu: a short-read mapper with SHRiMP2's capabilities, on JAX."""
import os

import jax

# Persistent compilation cache: pay each kernel shape's compile once
# across processes. JAX_COMPILATION_CACHE_DIR, where set, names the
# directory and JAX reads it itself; otherwise the cache lives in the
# checkout, at a fixed path so that later runs find it.
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update(
        "jax_compilation_cache_dir",
        os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), ".jax_cache"))
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
