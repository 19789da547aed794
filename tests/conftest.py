import sys

import numpy as np
import pytest

# NOTE: do NOT set xla_force_host_platform_device_count here — smoke tests
# and benches must see 1 device (the 512-device override is exclusively the
# dry-run's, set inside repro.launch.dryrun before jax init).

# Hermetic containers may lack hypothesis; substitute the deterministic
# fallback so the property tests still run (see _hypothesis_fallback.py).
try:
    import hypothesis  # noqa: F401
except ModuleNotFoundError:
    import _hypothesis_fallback

    sys.modules["hypothesis"] = _hypothesis_fallback
    sys.modules["hypothesis.strategies"] = _hypothesis_fallback.strategies


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skipped where there is none")


@pytest.fixture(scope="session")
def rng():
    return np.random.RandomState(0)
