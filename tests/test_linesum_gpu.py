"""The GPU line-sum kernel (ops.linesum_gpu) against the plain path.

The kernel runs here in Pallas interpret mode (the Triton route has an
interpreter); the reference is the float64 plain path
(ops.linesum.sigma_from_lines). The kernel computes in float32 with
two-float line positions, so agreement is at float32 roundoff where sigma is
radiatively relevant. The compiled kernel is checked on a card by the
``chip``-marked test at the end.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from clearsky_tpu import backend
from clearsky_tpu.ops import linesum as ls
from clearsky_tpu.ops.linesum import (
    DeviceWindowPlan,
    build_line_window_plan,
    sigma_from_lines,
    sigma_from_lines_device,
)
from clearsky_tpu.ops.linesum_gpu import (
    CHUNK,
    linesum_kernel,
    sigma_from_lines_gpu,
    sigma_from_lines_gpu_device,
)
from clearsky_tpu.spectra.synthetic import synthetic_lines

T4 = jnp.asarray([190.0, 240.0, 290.0, 320.0])
P4 = jnp.asarray([30.0, 3e3, 3e4, 1e5])


@pytest.fixture(scope="module")
def co2():
    return synthetic_lines("CO2", seed=0, maxlines=300)


def _rel(got, ref, floor=1e-8):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    m = ref >= floor * ref.max(axis=-1, keepdims=True)
    return float((np.abs(got - ref)[m] / ref[m]).max())


SHAPES = [("voigt", 25.0), ("voigt_ref", 25.0), ("lorentz", 25.0),
          ("doppler", 25.0), ("phco2", 60.0)]


@pytest.mark.parametrize("form", ["static", "device"])
@pytest.mark.parametrize("shape,cut", SHAPES)
def test_kernel_matches_f64_plain(co2, shape, cut, form):
    nu = np.linspace(620.0, 720.0, 2048)
    plan = build_line_window_plan(nu, np.asarray(co2.nu), cut)
    ref = sigma_from_lines(plan, co2, T4, P4, 0.2 * P4, shape)
    if form == "static":
        got = sigma_from_lines_gpu(plan, co2, T4, P4, 0.2 * P4, shape,
                                   interpret=True)
    else:
        got = sigma_from_lines_gpu_device(DeviceWindowPlan.from_plan(plan), co2,
                                          T4, P4, 0.2 * P4, shape,
                                          interpret=True)
    assert got.dtype == jnp.float32 and got.shape == ref.shape
    assert _rel(got, ref) < 2e-5


def test_kernel_empty_blocks_are_zero(co2):
    # a grid that starts far below the catalog: leading blocks have count 0
    # and must come out exactly zero (the window walk runs no chunk)
    nu_l = np.asarray(co2.nu)
    nu = np.linspace(nu_l.min() - 200.0, nu_l.min() + 20.0, 1024)
    plan = build_line_window_plan(nu, nu_l, 25.0)
    assert (plan.count == 0).sum() >= 2
    got = np.asarray(sigma_from_lines_gpu(plan, co2, T4, P4, 0.2 * P4,
                                          interpret=True))
    ref = np.asarray(sigma_from_lines(plan, co2, T4, P4, 0.2 * P4))
    empty = np.repeat(plan.count == 0, plan.block)[: len(nu)]
    assert np.all(got[:, empty] == 0.0)
    assert _rel(got, ref) < 2e-5


def test_kernel_window_longer_than_one_chunk(co2):
    # a wide cut puts hundreds of lines in every window: many chunks per
    # block, the last one partly masked
    nu = np.linspace(600.0, 740.0, 1024)
    plan = build_line_window_plan(nu, np.asarray(co2.nu), 100.0)
    assert plan.count.max() > 8 * CHUNK and np.any(plan.count % CHUNK)
    got = sigma_from_lines_gpu(plan, co2, T4, P4, 0.2 * P4, interpret=True)
    ref = sigma_from_lines(plan, co2, T4, P4, 0.2 * P4)
    assert _rel(got, ref) < 2e-5


@pytest.mark.parametrize("block", [128, 100])
def test_kernel_ragged_grid_and_block(co2, block):
    # n_nu not a multiple of the block; a block width that is not a power
    # of two is widened for the kernel and sliced back
    nu = np.linspace(640.0, 700.0, 1000)
    plan = build_line_window_plan(nu, np.asarray(co2.nu), 25.0, block=block)
    got = sigma_from_lines_gpu(plan, co2, T4, P4, 0.2 * P4, interpret=True)
    ref = sigma_from_lines(plan, co2, T4, P4, 0.2 * P4)
    assert got.shape == (4, 1000)
    assert _rel(got, ref) < 2e-5


def test_plain_path_sums_wide_slabs_in_chunks():
    # a 500 cm^-1 cut gives a slab wider than SLAB_CHUNK: the plain path
    # sums it in pieces, which must equal the dense direct sum
    lines = synthetic_lines("CO2", seed=0)
    nu = np.linspace(600.0, 760.0, 256)
    plan = build_line_window_plan(nu, np.asarray(lines.nu), 500.0)
    assert plan.slab > ls.SLAB_CHUNK
    T, P = jnp.asarray([230.0, 290.0]), jnp.asarray([5e3, 8e4])
    got = np.asarray(sigma_from_lines(plan, lines, T, P, 0.1 * P, "phco2"))
    S, a, g = ls._line_params(lines, T, P, 0.1 * P)
    dnu = jnp.asarray(nu)[:, None] - lines.nu[None, :]
    prof = ls.PROFILES["phco2"](dnu[None], S[:, None, :], a[:, None, :],
                                g[:, None, :], T[:, None, None])
    want = np.asarray(jnp.where(jnp.abs(dnu) <= 500.0, prof, 0.0).sum(-1))
    np.testing.assert_allclose(got, want, rtol=1e-10)


def test_kernel_rejects_unknown_shape_and_block():
    z = jnp.zeros((1, 128), jnp.float32)
    i = jnp.zeros((1,), jnp.int32)
    S = jnp.zeros((1, 4), jnp.float32)
    with pytest.raises(ValueError, match="line shape"):
        linesum_kernel(z, z, i, i, S[0], S[0], S, S, S, i, shape="gauss",
                       cut=25.0, interpret=True)
    z = jnp.zeros((1, 100), jnp.float32)
    with pytest.raises(ValueError, match="power of two"):
        linesum_kernel(z, z, i, i, S[0], S[0], S, S, S, i, shape="voigt",
                       cut=25.0, interpret=True)


def test_kernel_state_batches_and_concentrations(co2):
    # 2-D state batch with per-line concentrations (the MultiGas form)
    nu = np.linspace(640.0, 700.0, 512)
    plan = build_line_window_plan(nu, np.asarray(co2.nu), 25.0)
    T = T4.reshape(2, 2)
    P = P4.reshape(2, 2)
    conc = jnp.linspace(0.1, 0.9, co2.n_lines)
    got = sigma_from_lines_gpu(plan, co2, T, P, None, conc=conc, interpret=True)
    ref = sigma_from_lines(plan, co2, T, P, None, conc=conc)
    assert got.shape == (2, 2, 512)
    assert _rel(got.reshape(4, -1), ref.reshape(4, -1)) < 2e-5


def test_kernel_under_vmap(co2):
    nu = np.linspace(640.0, 700.0, 512)
    plan = build_line_window_plan(nu, np.asarray(co2.nu), 25.0)
    Tb = jnp.stack([T4, T4 + 7.0, T4 - 9.0])
    got = jax.vmap(lambda t: sigma_from_lines_gpu(
        plan, co2, t, P4, 0.2 * P4, interpret=True))(Tb)
    ref = jax.vmap(lambda t: sigma_from_lines(plan, co2, t, P4, 0.2 * P4))(Tb)
    assert _rel(got.reshape(12, -1), ref.reshape(12, -1)) < 2e-5


@pytest.mark.parametrize("form", ["static", "device"])
def test_kernel_jvp_is_the_plain_jvp(co2, form):
    # the custom JVP's tangent is exactly jax.jvp of the plain path
    nu = np.linspace(640.0, 700.0, 512)
    plan = build_line_window_plan(nu, np.asarray(co2.nu), 25.0)
    dplan = DeviceWindowPlan.from_plan(plan)
    dT = jnp.asarray([1.0, -0.5, 2.0, 0.25])
    if form == "static":
        k = lambda t: sigma_from_lines_gpu(plan, co2, t, P4, 0.2 * P4,
                                           interpret=True)
        p = lambda t: sigma_from_lines(plan, co2, t, P4, 0.2 * P4)
    else:
        k = lambda t: sigma_from_lines_gpu_device(dplan, co2, t, P4, 0.2 * P4,
                                                  interpret=True)
        p = lambda t: sigma_from_lines_device(dplan, co2, t, P4, 0.2 * P4)
    out_k, tan_k = jax.jvp(k, (T4,), (dT,))
    out_p, tan_p = jax.jvp(p, (T4,), (dT,))
    assert _rel(out_k, out_p) < 2e-5
    np.testing.assert_allclose(np.asarray(tan_k), np.asarray(tan_p, np.float32),
                               rtol=1e-6, atol=1e-6 * float(jnp.abs(tan_p).max()))


def test_kernel_interpret_ref_convention(co2):
    # the reference's HWHM-convention Voigt through the kernel
    nu = np.linspace(640.0, 700.0, 512)
    plan = build_line_window_plan(nu, np.asarray(co2.nu), 25.0)
    T, P = jnp.asarray([260.0]), jnp.asarray([2e4])
    oracle = sigma_from_lines(plan, co2, T, P, 0.9 * P, shape="voigt_ref")
    kern = sigma_from_lines_gpu(plan, co2, T, P, 0.9 * P, shape="voigt_ref",
                                interpret=True)
    assert _rel(kern, oracle) < 2e-5


def test_backend_choice_on_cpu():
    assert backend.platform() == "cpu"
    assert backend.linesum_impl() == "xla"
    assert backend.linesum_impl(jnp.float64) == "xla"
    assert backend.device_bake() is False


def test_backend_choice_on_gpu_and_unknown():
    assert backend.linesum_impl(jnp.float32, on="gpu") == "triton"
    # float64 references take the plain path on every platform
    assert backend.linesum_impl(jnp.float64, on="gpu") == "xla"
    assert backend.device_bake(on="gpu") is True
    with pytest.raises(RuntimeError, match="no line-sum implementation"):
        backend.linesum_impl(on="rocm")


def test_auto_dispatch_routes_by_backend(co2, monkeypatch):
    # on a (faked) GPU a float32 call reaches the kernel; on the CPU the
    # plain path; float64 always the plain path
    import clearsky_tpu.ops.linesum_gpu as lg

    calls = []
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(lg, "sigma_from_lines_gpu",
                        lambda *a, **k: calls.append("kernel") or "k")
    nu = np.linspace(640.0, 700.0, 256)
    plan = build_line_window_plan(nu, np.asarray(co2.nu), 25.0)
    lines32 = jax.tree.map(
        lambda x: x.astype(jnp.float32) if x.dtype == jnp.float64 else x, co2)
    assert ls.sigma_from_lines_auto(plan, lines32, T4, P4, P4) == "k"
    out = ls.sigma_from_lines_auto(plan, co2, T4, P4, 0.2 * P4)
    assert calls == ["kernel"] and out.shape == (4, 256)
    with pytest.raises(RuntimeError, match="unsupported JAX platform"):
        monkeypatch.setattr(jax, "default_backend", lambda: "rocm")
        ls.sigma_from_lines_auto(plan, co2, T4, P4, P4)


@pytest.mark.chip
def test_compiled_kernel_matches_plain_on_gpu(co2, gpu_device):
    nu = np.linspace(620.0, 720.0, 4096)
    with jax.default_device(gpu_device):
        for shape, cut in SHAPES:
            plan = build_line_window_plan(nu, np.asarray(co2.nu), cut)
            lines32 = jax.tree.map(
                lambda x: x.astype(jnp.float32) if x.dtype == jnp.float64 else x,
                co2)
            T = T4.astype(jnp.float32)
            P = P4.astype(jnp.float32)
            got = jax.jit(lambda t: sigma_from_lines_gpu(
                plan, lines32, t, P, 0.2 * P, shape))(T)
            ref = sigma_from_lines(plan, co2, T4, P4, 0.2 * P4, shape)
            assert _rel(got, ref) < 1e-4, shape
