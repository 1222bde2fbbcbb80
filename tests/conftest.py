import os
import sys

# Tests run on a virtual 8-device CPU mesh so multi-device sharding paths
# are exercised without a GPU. The ambient environment may pin
# JAX_PLATFORMS to an accelerator plugin, so force the config directly
# before any backend initialization.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

try:
    jax.config.update("jax_platforms", "cpu")
except Exception:
    pass

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import pytest  # noqa: E402

# `pytest -q` runs the FAST subset (<8 min on a 4-core host): core
# kernels, goldens, e2e basics. The multi-minute e2e/dist/flag-matrix
# modules are marked `slow` and run with `pytest --runslow` (the full
# pre-merge gate; ~30 min, tens of GB peak RSS).


def pytest_addoption(parser):
    parser.addoption(
        "--runslow", action="store_true", default=False,
        help="also run tests marked slow (the full gate)")


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: multi-minute e2e/dist case; excluded from the default "
        "fast subset (run with --runslow)")
    config.addinivalue_line(
        "markers",
        "gpu: compiles a kernel for the GPU; skips on any other JAX "
        "backend (chip_smoke.py runs the same comparisons on the card)")


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Skip `gpu` tests unless JAX's backend is the GPU. Decided here,
    per test, never while a module is imported: pytest-xdist workers
    must all collect the same tests."""
    if request.node.get_closest_marker("gpu") is None:
        return
    import jax
    if jax.default_backend() != "gpu":
        pytest.skip("needs the GPU backend; this test process runs on "
                    f"{jax.default_backend()!r}")


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow"):
        return
    skip = pytest.mark.skip(reason="slow: use --runslow for the full gate")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)
