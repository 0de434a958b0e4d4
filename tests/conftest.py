import os
import sys

import pytest

# Make src/, benchmarks/, and this directory importable without installation.
HERE = os.path.dirname(__file__)
sys.path.insert(0, os.path.join(HERE, "..", "src"))
sys.path.insert(0, os.path.join(HERE, "..", "benchmarks"))
sys.path.insert(0, HERE)

# The md/ suite needs 8 virtual devices (XLA_FLAGS must be set before jax
# initializes), so it runs in a subprocess spawned by test_multidevice.py.
# Exclude it from normal collection; the subprocess sets KAMPING_MD=1.
collect_ignore = [] if os.environ.get("KAMPING_MD") else ["md"]

# hypothesis is optional (offline environments): _hypothesis_compat falls
# back to deterministic seeded examples; when the real library is present,
# register the CI profile.
from _hypothesis_compat import HAVE_HYPOTHESIS  # noqa: E402

if HAVE_HYPOTHESIS:
    from hypothesis import settings

    settings.register_profile("ci", max_examples=25, deadline=None)
    settings.load_profile("ci")


def pytest_addoption(parser):
    parser.addoption(
        "--run-md",
        action="store_true",
        default=False,
        help="run the opt-in md/slow tests (subprocess-spawned 8-device suite)",
    )


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "md: multi-device subprocess suite (opt-in: --run-md or KAMPING_RUN_MD=1)",
    )
    config.addinivalue_line(
        "markers",
        "slow: long-running test (opt-in: --run-md or KAMPING_RUN_MD=1)",
    )
    config.addinivalue_line(
        "markers",
        "pallas: ring-collective kernel / transport-equivalence suites "
        "(run in tier-1; selectable for the interpret-mode CI leg via "
        "`-m pallas`)",
    )
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA card (the port's hand-written kernels have no "
        "CPU mode); skips without one",
    )


def pytest_collection_modifyitems(config, items):
    if config.getoption("--run-md") or os.environ.get("KAMPING_RUN_MD"):
        return
    skip = pytest.mark.skip(
        reason="md/slow suite is opt-in: pass --run-md or set KAMPING_RUN_MD=1"
    )
    for item in items:
        if "md" in item.keywords or "slow" in item.keywords:
            item.add_marker(skip)
