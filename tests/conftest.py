import os
import sys
from pathlib import Path

# smoke tests and benches must see 1 device — the 512-device override lives
# ONLY in launch/dryrun.py (run as a subprocess in test_dryrun).
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import jax  # noqa: E402

jax.config.update("jax_enable_x64", False)

# hypothesis is a dev-only dependency (requirements-dev.txt); property tests
# importorskip it themselves — without the guard a missing install would kill
# the whole suite at collection time.
try:
    from hypothesis import HealthCheck, settings  # noqa: E402
except ModuleNotFoundError:
    pass
else:
    # deterministic property tests (CI reproducibility)
    settings.register_profile(
        "ci", derandomize=True, deadline=None,
        suppress_health_check=[HealthCheck.too_slow])
    settings.load_profile("ci")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips without one")
