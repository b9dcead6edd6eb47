import os

# Tests run on the single real CPU device; only launch/dryrun.py (never
# imported here) sets the 512-placeholder XLA flag.
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

jax.config.update("jax_enable_x64", False)


def pytest_configure(config):
    # Registered here (not only pytest.ini) so `pytest tests/x.py` from any
    # rootdir still knows the markers; pytest.ini's `-m "not slow"` addopts
    # makes the fast tier the default — run everything with `pytest -m ""`.
    config.addinivalue_line(
        "markers",
        "slow: heavy compile/e2e test, excluded from the default tier-1 run "
        "(include with -m \"\" or -m slow)")
    config.addinivalue_line(
        "markers",
        "pallas: compiles/interprets Pallas kernels (slow on CPU interpret; "
        "the TPU-target kernels are exercised via their jnp refs elsewhere)")
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips without one")
