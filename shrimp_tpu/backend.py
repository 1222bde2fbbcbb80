"""The one platform decision: which kernel and which device flow runs.

Every kernel gate and flow choice in the package asks this module, so a
new platform is added here and nowhere else. JAX's default backend is
read once per process:

- ``gpu``: the vector Smith-Waterman filter runs as the Pallas Triton
  kernel (core/sw_pallas.py); every other DP is its XLA formulation, and
  the fast path uses the traceback-free stats flow.
- ``cpu``: every kernel is its XLA formulation (never Pallas interpret
  mode), and the fast path walks the traceback on the device.
- anything else: an error that names the platform.
"""
from __future__ import annotations

import dataclasses
import functools
import os

VEC_TRITON = "triton"
VEC_XLA = "xla"


@dataclasses.dataclass(frozen=True)
class Backend:
    """Kernel and flow choices for one platform."""
    platform: str
    vec_kernel: str        # VEC_TRITON or VEC_XLA
    stats_flow: bool       # device returns DP stats, host rebuilds paths


def choose(platform: str) -> Backend:
    """The choices for a JAX platform name (``jax.default_backend()``)."""
    if platform == "gpu":
        return Backend(platform, VEC_TRITON, stats_flow=True)
    if platform == "cpu":
        return Backend(platform, VEC_XLA, stats_flow=False)
    raise RuntimeError(
        f"shrimp_tpu runs on the 'gpu' and 'cpu' JAX platforms; the "
        f"default backend here is {platform!r}")


@functools.cache
def current() -> Backend:
    """The choices for this process's default JAX backend."""
    import jax
    return choose(jax.default_backend())


def vec_kernel() -> str:
    """Which vector-SW kernel the device launches use."""
    return current().vec_kernel


def stats_flow() -> bool:
    """Whether the LS fast path uses the traceback-free stats flow.
    SHRIMP_TPU_STATS_FLOW=0/1 overrides the platform's choice."""
    ov = os.environ.get("SHRIMP_TPU_STATS_FLOW")
    if ov is not None:
        return ov == "1"
    return current().stats_flow
