"""The one platform decision (shrimp_tpu/backend.py) and the compile
cache rule (shrimp_tpu/__init__.py)."""
import os
import subprocess
import sys

import pytest

from shrimp_tpu import backend

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_gpu_runs_triton_and_stats_flow():
    b = backend.choose("gpu")
    assert (b.vec_kernel, b.stats_flow) == (backend.VEC_TRITON, True)


def test_cpu_runs_xla_only():
    b = backend.choose("cpu")
    assert (b.vec_kernel, b.stats_flow) == (backend.VEC_XLA, False)


@pytest.mark.parametrize("platform", ["tpu", "rocm", "METAL"])
def test_unknown_platform_is_an_error(platform):
    with pytest.raises(RuntimeError, match=repr(platform)):
        backend.choose(platform)


def test_current_reads_the_default_backend():
    assert backend.current() == backend.choose("cpu")
    assert backend.vec_kernel() == backend.VEC_XLA


@pytest.mark.parametrize("env,want", [(None, False), ("1", True),
                                      ("0", False)])
def test_stats_flow_override(monkeypatch, env, want):
    if env is None:
        monkeypatch.delenv("SHRIMP_TPU_STATS_FLOW", raising=False)
    else:
        monkeypatch.setenv("SHRIMP_TPU_STATS_FLOW", env)
    assert backend.stats_flow() is want


def _compile_once(env_dir):
    """Compile one new program in a fresh process that imports the
    package; returns the entries of the cache directory it should use."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    n = 1000 + os.getpid() % 100000     # a shape no other test compiles
    subprocess.run(
        [sys.executable, "-c",
         "import shrimp_tpu, jax, jax.numpy as jnp; "
         f"jax.jit(lambda x: x * 3 + 1)(jnp.arange({n})).block_until_ready()"],
        cwd=ROOT, env=env, capture_output=True, timeout=120, check=True)
    d = env_dir or os.path.join(ROOT, ".jax_cache")
    return set(os.listdir(d)) if os.path.isdir(d) else set()


def test_cache_defaults_to_the_checkout():
    d = os.path.join(ROOT, ".jax_cache")
    before = set(os.listdir(d)) if os.path.isdir(d) else set()
    assert _compile_once(None) - before


def test_cache_follows_the_environment(tmp_path):
    assert _compile_once(str(tmp_path))
