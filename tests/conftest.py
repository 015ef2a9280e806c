"""Test configuration: CPU backend with 8 virtual devices, float64 enabled.

Multi-device sharding tests emulate a device mesh on CPU via
``xla_force_host_platform_device_count``. float64 gives reference-grade
numerics for the physics validation tests; the GPU path runs float32.

Tests marked ``chip`` need an NVIDIA GPU and skip without one. With
``CLEARSKY_TEST_GPU=1`` the GPU platform is registered beside the CPU
(the CPU stays the default device, so every other test is unchanged) and
the ``gpu_device`` fixture hands those tests the card:

    CLEARSKY_TEST_GPU=1 python -m pytest -m chip tests/
"""

import os

_PLATFORMS = "cpu,cuda" if os.environ.get("CLEARSKY_TEST_GPU") == "1" else "cpu"
os.environ["JAX_PLATFORMS"] = _PLATFORMS
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax

# set through the live config as well: the env var is too late if jax was
# imported (and its platforms chosen) before this file ran
jax.config.update("jax_platforms", _PLATFORMS)
jax.config.update("jax_enable_x64", True)

import numpy as np
import pytest

# directory of the upstream HITRAN test catalogs (CO2.par, H2O.par, CIA
# tables); tests that read them skip when it is not given
REF_FIXTURES = os.environ.get("CLEARSKY_HITRAN_DIR", "")


@pytest.fixture(scope="session")
def gpu_device():
    """The first GPU device; skips the test where there is none."""
    try:
        gpus = jax.devices("gpu")
    except RuntimeError:
        gpus = []
    if not gpus:
        pytest.skip("needs an NVIDIA GPU (run with CLEARSKY_TEST_GPU=1 on a card)")
    return gpus[0]


@pytest.fixture(scope="session")
def fixtures_dir():
    if not REF_FIXTURES or not os.path.isdir(REF_FIXTURES):
        pytest.skip("HITRAN test catalogs not available (set CLEARSKY_HITRAN_DIR)")
    return REF_FIXTURES


def gray_analytic_olr(sigma, G, MU, CP, PS, TS):
    """Closed-form gray-atmosphere OLR (Pierrehumbert eq. 4.32) on a dry
    adiabat — the shared analytic anchor for both flux engines' gray tests
    (ref test_gray.jl:15-24)."""
    from scipy.integrate import quad
    from clearsky_tpu.constants import R_GAS, SIGMA_SB, N_AVOGADRO

    tau_inf = 1e-4 * sigma * N_AVOGADRO / (MU * G) * PS
    gam = R_GAS / (MU * CP)
    I, _ = quad(lambda t: np.exp(-t) * t ** (4 * gam), 0, tau_inf, limit=500)
    return SIGMA_SB * TS**4 * (np.exp(-tau_inf) + tau_inf ** (-4 * gam) * I)
