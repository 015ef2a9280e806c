"""Benchmark on one NVIDIA GPU: the line-sum kernel against the plain path,
alone and end to end, and the flux-march scan at several unroll factors.

Workloads, all on the seeded synthetic CO2 catalog (5,599 lines,
``clearsky_tpu.spectra.synthetic``) on 2^19 points spanning the catalog
+-25 cm^-1:

* line sum alone: 16 (T, P) states, voigt at cut 25 and phco2 at cut 500;
  the kernel (``ops.linesum_gpu``) and the plain path
  (``ops.linesum.sigma_from_lines``), both float32;
* end to end: direct-mode band OLR (line sum at 19 layers x 3 Lobatto nodes
  -> optical depth -> Planck -> 5-stream march -> spectral integral) with
  each line-sum implementation;
* the scan march (``rt.discretized``): 19 layers x 5 streams, ``monoflux``
  and ``outgoing_flux``, at unroll 1, 2, 4 and 8.

Times are medians of warm runs ended by ``block_until_ready``; compile time
is reported on its own. Runs only on a GPU. Prints the card's name and power
limit, then ONE JSON line.

    python bench.py
"""

import json
import statistics
import time

import numpy as np

N_NU = 2**19
N_STATES = 16
N_LEVELS = 20
NSTREAM = 5
NLOBATTO = 3
REPS = 7


def _timed(fn, *args, reps=REPS):
    """(compile_s, median_run_s, output) of jax.jit(fn) on args."""
    import jax

    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    t_compile = time.perf_counter() - t0
    out = jax.block_until_ready(compiled(*args))  # warm-up
    runs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(*args))
        runs.append(time.perf_counter() - t0)
    return t_compile, statistics.median(runs), out


def _setup():
    from clearsky_tpu.spectra.synthetic import synthetic_lines

    lines = synthetic_lines("CO2", seed=0)
    nu_l = np.asarray(lines.nu, np.float64)
    nu = np.linspace(nu_l.min() - 25.0, nu_l.max() + 25.0, N_NU)
    return lines, nu


def _states(n):
    T = np.linspace(180.0, 320.0, n)
    P = np.exp(np.linspace(np.log(10.0), np.log(1e5), n))
    return T, P


def bench_linesum(lines, nu, shape, cut, device_kind):
    """Kernel and plain line sum alone: times, agreement, kernel roofline."""
    import jax.numpy as jnp
    from clearsky_tpu.ops.linesum import build_line_window_plan, sigma_from_lines
    from clearsky_tpu.ops.linesum_gpu import sigma_from_lines_gpu
    from clearsky_tpu.utils.profiling import linesum_cost, roofline_report

    plan = build_line_window_plan(nu, np.asarray(lines.nu), cut)
    T, P = _states(N_STATES)
    Tj, Pj = jnp.asarray(T, jnp.float32), jnp.asarray(P, jnp.float32)
    Pp = 0.95 * Pj
    ck, tk, sk = _timed(lambda t: sigma_from_lines_gpu(plan, lines, t, Pj, Pp, shape), Tj)
    cp, tp, sp = _timed(lambda t: sigma_from_lines(plan, lines, t, Pj, Pp, shape), Tj)
    sk, sp = np.asarray(sk), np.asarray(sp)
    m = sp >= 1e-8 * sp.max(axis=-1, keepdims=True)
    cost = linesum_cost(plan, N_STATES)
    roof = roofline_report(cost, tk, device_kind)
    return {
        "shape": shape, "cut": cut, "kernel_ms": tk * 1e3, "plain_ms": tp * 1e3,
        "kernel_compile_s": ck, "plain_compile_s": cp,
        "kernel_vs_plain_max_rel": float((np.abs(sk - sp)[m] / sp[m]).max()),
        "kernel_fraction_of_roof": roof["fraction_of_roof"],
        "kernel_bound": roof["bound"],
        "useful_evals_per_s": roof["useful_evals_per_s"],
        "block_count_quartiles": np.percentile(plan.count, [0, 25, 50, 75, 100]).tolist(),
        "slab": plan.slab,
    }


class _LineSumAbsorber:
    """Absorber view (``nu`` + ``sigma(T, P)``) over one line-sum function."""

    def __init__(self, fn, plan, lines, nu, conc):
        self.fn, self.plan, self.lines, self.conc = fn, plan, lines, conc
        self.nu = nu

    def sigma(self, T, P):
        return self.conc * self.fn(self.plan, self.lines, T, P,
                                   self.conc * P, "voigt")


def bench_olr(lines, nu):
    """Direct-mode band OLR with the kernel and with the plain line sum."""
    import jax.numpy as jnp
    from clearsky_tpu.atmosphere.profile import formprofiles
    from clearsky_tpu.constants import R_GAS
    from clearsky_tpu.ops.linesum import build_line_window_plan, sigma_from_lines
    from clearsky_tpu.ops.linesum_gpu import sigma_from_lines_gpu
    from clearsky_tpu.rt.discretized import outgoing_flux
    from clearsky_tpu.rt.fluxes import _column_tau, _planck_levels
    from clearsky_tpu.utils.grids import pressuregrid, trapz

    G, MU, CP, PS, PT = 9.8, 0.044, 850.0, 1e5, 10.0
    Pe = pressuregrid(PT, PS, N_LEVELS)
    Te = np.maximum(288.0 * (Pe / PS) ** (R_GAS / (MU * CP)), 160.0)
    Pg = jnp.asarray(Pe, jnp.float32)
    nuj = jnp.asarray(nu, jnp.float32)
    plan = build_line_window_plan(nu, np.asarray(lines.nu), 25.0)
    out = {}
    for name, fn in (("kernel", sigma_from_lines_gpu), ("plain", sigma_from_lines)):
        A = _LineSumAbsorber(fn, plan, lines, nuj, 0.95)

        def olr(T, A=A):
            fT, fmu = formprofiles(Pg, T, MU)
            tau = _column_tau(Pg, G, fT, fmu, A, NLOBATTO)
            M = outgoing_flux(tau, _planck_levels(Pg, nuj, fT), NSTREAM)
            return trapz(nuj, M)

        c, t, band = _timed(olr, jnp.asarray(Te, jnp.float32))
        out[f"olr_{name}_ms"] = t * 1e3
        out[f"olr_{name}_compile_s"] = c
        out[f"olr_{name}_band_W_m2"] = float(band)
    return out


def bench_march_unroll(unrolls=(1, 2, 4, 8)):
    """Scan march times (monoflux, outgoing_flux) per unroll factor."""
    import jax.numpy as jnp
    from clearsky_tpu.rt import discretized as disc

    rng = np.random.default_rng(0)
    L = N_LEVELS - 1
    tau = jnp.asarray(rng.exponential(0.5, (L, N_NU)), jnp.float32)
    B = jnp.asarray(0.5 + rng.random((L + 1, N_NU)), jnp.float32)
    S = jnp.asarray(rng.random(N_NU), jnp.float32)
    a = jnp.asarray(0.3 * rng.random(N_NU), jnp.float32)
    out = {}
    saved = disc._UNROLL
    try:
        for u in unrolls:
            disc._UNROLL = u  # read at trace time; each _timed call re-traces
            _, t_mono, _ = _timed(
                lambda t: disc.monoflux(t, B, None, S, a, 0.841, NSTREAM), tau)
            _, t_olr, _ = _timed(lambda t: disc.outgoing_flux(t, B, NSTREAM), tau)
            out[f"unroll_{u}"] = {"monoflux_ms": t_mono * 1e3,
                                  "outgoing_ms": t_olr * 1e3}
    finally:
        disc._UNROLL = saved
    return out


def main():
    import jax
    from clearsky_tpu.utils.compile_cache import enable_compile_cache
    from clearsky_tpu.utils.profiling import card_name_and_power_limit

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py measures the GPU; found platform {dev.platform!r}")
    enable_compile_cache()
    card = card_name_and_power_limit()
    print(card)
    lines, nu = _setup()
    rec = {
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card,
        "linesum_voigt": bench_linesum(lines, nu, "voigt", 25.0, dev.device_kind),
        "linesum_phco2": bench_linesum(lines, nu, "phco2", 500.0, dev.device_kind),
        "direct_olr": bench_olr(lines, nu),
        "march_scan": bench_march_unroll(),
    }
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
