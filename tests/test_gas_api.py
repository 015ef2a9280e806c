"""Gas API parity surface: alias constructors, wavenumber slicing, raw/scaled."""

import numpy as np
import jax.numpy as jnp
import pytest

from clearsky_tpu import (
    AtmosphericDomain,
    Gas,
    WellMixedGas,
    VariableGas,
)


@pytest.fixture(scope="module")
def co2():
    from clearsky_tpu.spectra.synthetic import synthetic_lines

    return synthetic_lines("CO2", seed=0)


@pytest.fixture(scope="module")
def baked(co2):
    nu = np.linspace(640.0, 680.0, 48)
    domain = AtmosphericDomain.create((150.0, 350.0), 6, (10.0, 1e5), 8)
    gas = Gas.from_lines(co2, 400e-6, nu, domain)
    return gas, nu, domain


def test_wellmixed_alias_scales_by_concentration(baked):
    gas, nu, domain = baked
    T = jnp.asarray([250.0])
    P = jnp.asarray([1e4])
    np.testing.assert_allclose(
        np.asarray(gas(T, P)), 400e-6 * np.asarray(gas.raw_sigma(T, P)), rtol=1e-12
    )
    with pytest.raises(ValueError, match="well-mixed concentration"):
        WellMixedGas("x.par", 1.5, nu, domain)


def test_variable_gas_requires_callable(baked):
    _, nu, domain = baked
    with pytest.raises(TypeError, match="callable"):
        VariableGas("x.par", 0.5, nu, domain)


def test_select_slices_wavenumbers(baked):
    gas, nu, _ = baked
    sub = gas.select(np.arange(10, 20))
    assert sub.nu.shape == (10,)
    T = jnp.asarray([260.0])
    P = jnp.asarray([5e3])
    np.testing.assert_allclose(
        np.asarray(sub(T, P)), np.asarray(gas(T, P))[:, 10:20], rtol=1e-12
    )


def test_reconcentrate_swaps_closure(baked):
    gas, nu, _ = baked
    g2 = gas.reconcentrate(800e-6)
    T = jnp.asarray([250.0])
    P = jnp.asarray([1e4])
    np.testing.assert_allclose(
        np.asarray(g2(T, P)), 2.0 * np.asarray(gas(T, P)), rtol=1e-12
    )


def test_f32_bake_accuracy_bound(co2):
    """Tables baked through the float32 GPU kernel vs the f64 plain path.

    A GPU bake runs the f32 line-sum kernel (here in interpret mode): the
    interpolation-error harness must hold against an exact f64 line sum
    within the ~1% domain guidance (ref gases.jl:7) plus the kernel's own
    f32 noise.
    """
    from clearsky_tpu.absorption.gas import bake_sigma_grid, opacity_error
    from clearsky_tpu.ops.linesum import build_line_window_plan
    from clearsky_tpu.ops.linesum_gpu import sigma_from_lines_gpu

    lines = co2
    nu = np.linspace(640.0, 680.0, 48)
    domain = AtmosphericDomain.create((150.0, 350.0), 12, (10.0, 1e5), 24)

    sig64 = bake_sigma_grid(lines, 400e-6, nu, domain, backend="oracle")
    plan = build_line_window_plan(nu, np.asarray(lines.nu), 25.0)
    TT, PP = np.meshgrid(domain.T, domain.P, indexing="ij")
    Tf, Pf = jnp.asarray(TT.ravel()), jnp.asarray(PP.ravel())
    sig32 = np.asarray(sigma_from_lines_gpu(
        plan, lines, Tf, Pf, 400e-6 * Pf, interpret=True
    ), np.float64).reshape(sig64.shape)
    # kernel-vs-oracle at the bake nodes: pure f32 pipeline noise
    m = sig64 > sig64.max() * 1e-12
    node_rel = np.abs(sig32[m] - sig64[m]) / sig64[m]
    assert node_rel.max() < 2e-3, node_rel.max()

    # full harness: f32-baked table vs exact f64 line sum on a dense T x P grid
    from clearsky_tpu.absorption.gas import Gas, _ln_sigma_coeffs
    import jax.numpy as jnp_

    gas32 = Gas(
        nu=jnp_.asarray(nu),
        coeffs=jnp_.asarray(_ln_sigma_coeffs(sig32, domain)),
        name=lines.name,
        formula=lines.formula,
        mu=lines.mean_molar_mass,
        domain=domain,
        fC=lambda T, P: jnp_.full(jnp_.shape(jnp_.asarray(T) * jnp_.asarray(P)), 400e-6),
    )
    iv = int(np.argmax(sig64.max(axis=(0, 1))))  # strongest wavenumber
    _, _, _, rerr = opacity_error(gas32, lines, iv, N=30)
    # reference guidance: ~1% max at 12x24 nodes; f32 noise adds ~0.1%
    assert np.nanmax(np.abs(rerr)) < 0.02, np.nanmax(np.abs(rerr))


def test_profiling_cost_model():
    from clearsky_tpu.ops.linesum import build_line_window_plan
    from clearsky_tpu.utils.profiling import linesum_cost, roofline_report

    nu = np.linspace(1.0, 100.0, 512)
    nul = np.sort(np.random.default_rng(0).uniform(1.0, 100.0, 200))
    plan = build_line_window_plan(nu, nul, 25.0, block=128)
    cost = linesum_cost(plan, n_states=4)
    assert cost.flops > 0 and cost.bytes_moved > 0 and cost.evals > 0
    assert cost.flops >= cost.useful_flops
    rep = roofline_report(cost, 0.01, "NVIDIA H100 80GB HBM3")
    assert 0 < rep["fraction_of_roof"]
    assert rep["achieved_flops"] == pytest.approx(cost.flops / 0.01)


def test_table_contractions_pin_highest_precision():
    """The ln-sigma matmuls MUST carry Precision.HIGHEST: a default or HIGH
    f32 matmul runs in TF32 on the GPU (10 mantissa bits), and a 0.4%
    relative error on ln(sigma) of magnitude ~50-90 exponentiates into
    20-75% sigma errors. The bug cannot reproduce on CPU (true-f32
    matmuls), so this guards the traced precision attribute itself.
    """
    import jax
    from clearsky_tpu.absorption.domain import AtmosphericDomain
    from clearsky_tpu.absorption.gas import Gas
    from clearsky_tpu.spectra.synthetic import synthetic_lines
    from clearsky_tpu.utils.interp import cheb2d_coeffs

    lines = synthetic_lines("CO2", seed=0, maxlines=50)
    nu_l = np.asarray(lines.nu)
    nu = np.linspace(nu_l.min() - 25.0, nu_l.max() + 25.0, 128)
    dom = AtmosphericDomain.create((150.0, 350.0), 4, (10.0, 1e5), 6)
    g = Gas.from_lines(lines, 0.9, nu, dom)
    txt = str(jax.make_jaxpr(lambda T, P: g.raw_sigma(T, P))(
        jnp.asarray([250.0]), jnp.asarray([1e4])
    ))
    dots = txt.split("dot_general")[1:]
    assert dots, "table eval has no contraction"
    for d in dots:
        head = d[:300]
        assert "Precision.HIGHEST" in head, "table eval lost its HIGHEST pin"
        assert "Precision.HIGH," not in head and "Precision.HIGH)" not in head

    # the bake-time Chebyshev transform too
    txt2 = str(jax.make_jaxpr(cheb2d_coeffs)(jnp.ones((3, 4, 5))))
    assert "Precision.HIGHEST" in txt2, "cheb2d_coeffs lost its precision pin"


def test_split_precision_accuracy_and_surface(baked, tmp_path):
    """Split-precision storage (f32/f64 lead + bf16 tail, round 5): the
    evaluated table must stay within ~3e-3 of the full-precision table —
    far inside the ~1.3e-2 intrinsic production fit class — and the whole
    Gas surface (select, checkpoint round-trip) must keep working."""
    import jax
    from clearsky_tpu.utils.checkpoint import save_gas, load_gas

    gas, nu, domain = baked
    gs = gas.split_precision(k=16)
    assert gs.coeffs.shape[0] == 16
    assert gs.coeffs_tail.shape[0] == domain.nT * domain.nP - 16
    assert gs.coeffs_tail.dtype == jnp.bfloat16
    assert sorted(gs.lead_idx + gs.tail_idx) == list(range(domain.nT * domain.nP))

    T = jnp.asarray(np.linspace(160.0, 340.0, 9))
    P = jnp.asarray(10 ** np.linspace(1.1, 4.9, 9))
    full = np.asarray(gas.raw_sigma(T, P))
    split = np.asarray(gs.raw_sigma(T, P))
    mask = full > 1e-8 * full.max()
    rel = np.abs(split - full)[mask] / full[mask]
    assert rel.max() < 3e-3, f"split-precision error {rel.max():.2e}"

    # select keeps both tensors aligned
    sel = gs.select(np.arange(0, 48, 2))
    np.testing.assert_allclose(
        np.asarray(sel.raw_sigma(T, P)), split[:, ::2], rtol=1e-6
    )

    # checkpoint round-trips the bf16 tail bit-exactly
    p = str(tmp_path / "split_gas.npz")
    save_gas(p, gs)
    g2 = load_gas(p, fC=gs.fC)
    np.testing.assert_array_equal(
        np.asarray(g2.coeffs_tail).view(np.uint16),
        np.asarray(gs.coeffs_tail).view(np.uint16),
    )
    assert g2.lead_idx == gs.lead_idx
    np.testing.assert_allclose(
        np.asarray(g2.raw_sigma(T, P)), split, rtol=1e-6
    )

    # jaxpr guard: the lead contraction keeps its precision pin and the
    # bf16 tail matmul accumulates at the working dtype (preferred f32/f64)
    txt = str(jax.make_jaxpr(lambda t, p: gs.raw_sigma(t, p))(T, P))
    assert "Precision.HIGHEST" in txt, "split lead matmul lost its precision pin"
    assert "bf16" in txt and "preferred_element_type" in txt
