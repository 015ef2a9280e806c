"""Voigt width-convention switch: reproduce the reference formula exactly.

The framework's default Voigt uses the internally consistent 1/e-width
formula (``ops.lineshape.fvoigt``); the reference mixes conventions
(ClearSky.jl ``line_shapes.jl:366-378`` applies the HWHM-convention sqrt(ln2)
factors to the 1/e width from ``αdoppler``), inflating the effective Doppler
width by 1/sqrt(ln2) ~ 1.20x. For allclose cross-validation against reference
outputs, the ``'voigt_ref'``/``'phco2_ref'`` shapes reproduce the reference
formula to float64 roundoff; the flux-level impact of the convention is
quantified here and recorded in BASELINE.md.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from clearsky_tpu.ops.faddeeva import wofz_re
from clearsky_tpu.ops.lineshape import fvoigt, fvoigt_ref
from clearsky_tpu.ops.linesum import (
    PROFILES,
    build_line_window_plan,
    sigma_from_lines,
)

_SQRT_LN2 = np.sqrt(np.log(2.0))


def test_fvoigt_ref_matches_reference_formula():
    """Literal transcription of ref line_shapes.jl:366-378 vs fvoigt_ref."""
    rng = np.random.default_rng(0)
    dnu = jnp.asarray(rng.uniform(-20.0, 20.0, 256))
    alpha = jnp.asarray(rng.uniform(1e-3, 1.0, 256))
    gamma = jnp.asarray(rng.uniform(1e-4, 1.0, 256))
    # the reference formula, written out
    x = _SQRT_LN2 * dnu / alpha
    y = _SQRT_LN2 * gamma / alpha
    expect = (_SQRT_LN2 / (alpha * np.sqrt(np.pi))) * wofz_re(x, y)
    np.testing.assert_allclose(
        np.asarray(fvoigt_ref(dnu, alpha, gamma)), np.asarray(expect), rtol=1e-14
    )
    # algebraic identity used by the kernels: alpha -> alpha/sqrt(ln2)
    np.testing.assert_allclose(
        np.asarray(fvoigt(dnu, alpha / _SQRT_LN2, gamma)),
        np.asarray(expect),
        rtol=1e-13,
    )
    # PROFILES entry agrees
    got = PROFILES["voigt_ref"](dnu, 1.0, alpha, gamma, 250.0)
    np.testing.assert_allclose(np.asarray(got), np.asarray(expect), rtol=1e-13)


def test_convention_limits():
    # as gamma -> 0 the reference convention widens the Gaussian core by
    # 1/sqrt(ln2); at line center the profile scales by sqrt(ln2)
    alpha = jnp.asarray(0.1)
    f_int = float(fvoigt(0.0, alpha, 1e-12))
    f_ref = float(fvoigt_ref(0.0, alpha, 1e-12))
    np.testing.assert_allclose(f_ref / f_int, _SQRT_LN2, rtol=1e-6)


def test_sigma_ref_convention_kernel(fixtures_dir):
    """Kernel-level: shape='voigt_ref' equals per-line reference-formula sum."""
    from clearsky_tpu.spectra.lines import SpectralLines
    from clearsky_tpu.ops.linesum import _line_params

    lines = SpectralLines.from_par(f"{fixtures_dir}/CO2.par", maxlines=80)
    nu_l = np.asarray(lines.nu)
    nu = np.linspace(nu_l.min() - 10, nu_l.max() + 10, 257)
    plan = build_line_window_plan(nu, nu_l, 25.0)
    T, P = jnp.asarray([260.0]), jnp.asarray([2e4])
    sig = np.asarray(
        sigma_from_lines(plan, lines, T, P, 0.9 * P, shape="voigt_ref")
    )[0]
    # dense direct sum with the literal reference formula
    S, alpha, gamma = _line_params(lines, T, P, 0.9 * P)
    dnu = nu[:, None] - nu_l[None, :]
    prof = np.asarray(fvoigt_ref(jnp.asarray(dnu), alpha[0][None, :], gamma[0][None, :]))
    mask = np.abs(dnu) <= 25.0
    expect = (np.asarray(S)[0][None, :] * prof * mask).sum(axis=1)
    np.testing.assert_allclose(sig, expect, rtol=1e-10, atol=expect.max() * 1e-13)


@pytest.mark.slow
def test_flux_level_convention_delta(fixtures_dir):
    """Quantify the band-integrated OLR delta between conventions (BASELINE.md)."""
    from clearsky_tpu.spectra.lines import SpectralLines
    from clearsky_tpu.absorption.gas import DirectGas
    from clearsky_tpu.rt.fluxes import outgoing
    from clearsky_tpu.utils.grids import trapz

    lines = SpectralLines.from_par(f"{fixtures_dir}/CO2.par")
    nu_l = np.asarray(lines.nu)
    nu = np.linspace(max(nu_l.min() - 25.0, 1.0), nu_l.max() + 25.0, 4096)

    def olr(shape):
        gas = DirectGas.from_lines(lines, 0.95, nu, shape=shape)
        def fT(P):
            return jnp.maximum(
                290.0 * (jnp.asarray(P) / 1e5) ** 0.16, 170.0
            )
        o = outgoing(1e5, 9.8, fT, lambda T, P: 0.044, gas)
        return float(trapz(jnp.asarray(nu), o))

    o_int = olr("voigt")
    o_ref = olr("voigt_ref")
    rel = abs(o_ref - o_int) / o_int
    # the ~1.20x Doppler-width inflation only matters where Doppler dominates
    # (low pressure); band-integrated OLR moves well under 1%
    assert rel < 0.01, (o_int, o_ref)
    print(f"OLR internal={o_int:.4f} ref-convention={o_ref:.4f} rel delta={rel:.3e}")
