"""Demo: latitude x insolation RCE sweep on a device mesh (BASELINE config 5).

Computes annual-mean insolation factors across latitudes for an elliptical
orbit, then integrates a batch of RCE columns — all latitudes at once,
sharded over a ('batch', 'nu') mesh — and prints the equilibrium
surface-temperature profile by latitude.

The default absorber is the flagship line-by-line path: a fused CO2+H2O
MultiGas from the HITRAN fixtures (per-column cross-section refresh through
the Voigt line-sum kernel on every ``--update-every`` cadence). ``--gray``
restores the old gray-gas configuration.

Usage:
  python scripts/exoplanet_sweep_demo.py [--nlat N] [--steps N] [--gray]
  python scripts/exoplanet_sweep_demo.py --bench   # GPU columns/s measurement
"""

import argparse
import sys
import time

sys.path.insert(0, ".")

import numpy as np
import jax
import jax.numpy as jnp

CO2_PAR = "/root/reference/test/HITRAN/CO2.par"
H2O_PAR = "/root/reference/test/HITRAN/H2O.par"


def build_rcm(args):
    from clearsky_tpu import GrayGas, RCM
    from clearsky_tpu.absorption.gas import MultiGas
    from clearsky_tpu.spectra.lines import SpectralLines
    from clearsky_tpu.utils.grids import pressuregrid, logrange
    from clearsky_tpu.constants import R_GAS

    G, MU, CP, PS = 9.8, 0.044, 850.0, 1e5
    if args.gray:
        MU = 0.029
        nu = np.concatenate([logrange(1e-6, 1e4, args.nnu - 1, 3), [1e5]])
        gas = GrayGas.create(4e-27, nu)
    else:
        kw = {"maxlines": args.maxlines} if args.maxlines else {}
        co2 = SpectralLines.from_par(CO2_PAR, **kw)
        h2o = SpectralLines.from_par(H2O_PAR, **kw)
        nu_l = np.asarray(co2.nu)
        nu = np.linspace(max(nu_l.min() - 25.0, 1.0), nu_l.max() + 25.0, args.nnu)
        gas = MultiGas.from_lines([(co2, 0.9), (h2o, 0.005)], nu)
    Pe = pressuregrid(10.0, PS, args.nlev)
    Te = np.maximum(255.0 * (Pe / PS) ** (R_GAS / (MU * CP)), 150.0)
    S0 = 340.0 / np.cos(0.841)
    # normalize the flat stellar spectrum by the ACTUAL grid span so its
    # trapz integral is S0
    span = float(nu[-1] - nu[0])
    fS = lambda v: jnp.full(jnp.shape(v), S0 / span)
    r = RCM.create(Pe, Te, G, lambda T, P: MU, fS, 0.1, lambda T, P: CP, 1e6, gas)
    return r, len(nu), MU, CP


def batch_curve(args):
    """Column-steps/s vs batch size: a curve, not a point.

    The batch axis is the framework's cheapest axis; this maps where it
    saturates. Per batch size: build the sweep at that many latitude
    columns, run a fixed-step chain with warm-up, report column-steps/s and
    the per-step wall — the knee of the curve is where the per-column
    marginal cost stops falling (the merged-catalog σ refresh against the
    batched march filling the card).
    """
    import copy

    from clearsky_tpu import annualfluxfactors
    from clearsky_tpu.models.sweep import run_sweep, shard_sweep
    from clearsky_tpu.parallel import spectral_mesh

    MU, CP = 0.044, 850.0
    base = None
    prev_rate = None
    for nlat in (8, 16, 32, 64, 128, 256, 512, 1024):
        a = copy.copy(args)
        a.nlat = nlat
        theta, F = annualfluxfactors(args.ecc, args.obliquity, 0.0, ntheta=nlat)
        factors = 4.0 * jnp.asarray(F)
        r, n_nu, MU, CP = build_rcm(a)
        mesh = spectral_mesh(n_batch=1)
        r_s, f_s, T_s = shard_sweep(mesh, r, factors)
        sweep = jax.jit(
            lambda rr, ff, tt, ns: run_sweep(
                rr, ff, 2e4, ns, T0_b=tt,
                update_every=args.update_every, adjust_every=1, cp=CP, mu=MU,
            ),
            static_argnums=(3,),
        )
        K = 32
        jax.block_until_ready(sweep(r_s, f_s, T_s, K))  # compile + settle
        t1 = time.perf_counter()
        jax.block_until_ready(sweep(r_s, f_s, T_s, K))
        dt = time.perf_counter() - t1
        rate = nlat * K / dt
        if base is None:
            base = rate
        marg = "" if prev_rate is None else f", marginal {rate/prev_rate/2:.2f}x/doubling"
        prev_rate = rate
        print(f"  nlat {nlat:4d}: {rate:8.1f} column-steps/s  "
              f"({dt/K*1e3:7.2f} ms/sweep-step, {rate/base:5.2f}x of nlat=8"
              f"{marg})",
              flush=True)


def main():
    from clearsky_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--nlat", type=int, default=8)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--nnu", type=int, default=4096)
    ap.add_argument("--nlev", type=int, default=16)
    ap.add_argument("--maxlines", type=int, default=0, help="0 = full catalogs")
    ap.add_argument("--update-every", type=int, default=4)
    ap.add_argument("--ecc", type=float, default=0.0167)
    ap.add_argument("--obliquity", type=float, default=0.41)
    ap.add_argument("--gray", action="store_true")
    ap.add_argument("--bench", action="store_true",
                    help="measure sweep throughput (columns*steps/s)")
    ap.add_argument("--curve", action="store_true",
                    help="map column-steps/s vs batch size (16/64/256 cols)")
    args = ap.parse_args()
    if args.curve:
        return batch_curve(args)

    from clearsky_tpu import annualfluxfactors
    from clearsky_tpu.models.sweep import run_sweep, shard_sweep
    from clearsky_tpu.parallel import spectral_mesh

    G, MU, CP = 9.8, 0.044, 850.0
    t0 = time.time()

    theta, F = annualfluxfactors(args.ecc, args.obliquity, 0.0, ntheta=args.nlat)
    factors = 4.0 * jnp.asarray(F)  # normalize so the global mean factor is ~1

    r, n_nu, MU, CP = build_rcm(args)
    n_dev = len(jax.devices())
    n_batch = 2 if (n_dev % 2 == 0 and n_dev > 1 and args.nlat % 2 == 0) else 1
    mesh = spectral_mesh(n_batch=n_batch)
    r_s, f_s, T_s = shard_sweep(mesh, r, factors)
    kind = "gray" if args.gray else "CO2+H2O MultiGas LBL"
    print(f"[{time.time()-t0:5.1f}s] mesh {dict(mesh.shape)}, {kind}, "
          f"{args.nlat} latitude columns x {n_nu} wavenumbers")

    sweep = jax.jit(
        lambda rr, ff, tt, ns: run_sweep(
            rr, ff, 2e4, ns, T0_b=tt,
            update_every=0 if args.gray else args.update_every,
            adjust_every=1, cp=CP, mu=MU,
        ),
        static_argnums=(3,),
    )

    if args.bench:
        # throughput: time a fixed-step chain after a warm-up call of the
        # same length (compile apart), ended by block_until_ready
        K = max(args.steps, 16)
        jax.block_until_ready(sweep(r_s, f_s, T_s, K))
        t1 = time.perf_counter()
        jax.block_until_ready(sweep(r_s, f_s, T_s, K))
        dt = time.perf_counter() - t1
        rate = args.nlat * K / dt
        print(f"[bench] {args.nlat} cols x {K} steps in {dt:.2f}s "
              f"-> {rate:.1f} column-steps/s ({rate/args.nlat:.1f} steps/s, "
              f"{dt/K*1e3:.2f} ms/sweep-step)")
        return

    T_b, _ = sweep(r_s, f_s, T_s, args.steps)
    T_b = np.asarray(jax.block_until_ready(T_b))
    print(f"[{time.time()-t0:5.1f}s] {args.steps} steps x {args.nlat} columns")
    print("  latitude [deg]   forcing factor   surface T [K]")
    for th, f, Ts in zip(np.asarray(theta), np.asarray(factors), T_b[:, -1]):
        # the printed factor is the one the column was actually driven with
        print(f"    {np.degrees(th):8.1f}       {float(f):8.4f}      {Ts:8.2f}")


if __name__ == "__main__":
    main()
