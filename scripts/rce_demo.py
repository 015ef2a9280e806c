"""Demo: Earth-like radiative-convective equilibrium with CO2 + H2O.

Builds a line-by-line column from the bundled HITRAN fixtures, integrates it
to radiative-convective equilibrium with cross-section refresh and dry
convective adjustment, and prints the equilibrium diagnostics.

Usage: python scripts/rce_demo.py [--steps N] [--nnu N]
Works on an NVIDIA GPU (fast) or the CPU (set JAX_PLATFORMS=cpu; slower).
"""

import argparse
import sys
import time

sys.path.insert(0, ".")

import numpy as np
import jax
import jax.numpy as jnp


def main():
    from clearsky_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--nnu", type=int, default=4096)
    ap.add_argument("--par-dir", default="/root/reference/test/HITRAN")
    args = ap.parse_args()

    from clearsky_tpu import (
        SpectralLines, DirectGas, RCM, run, radiate_state, trapz,
    )
    from clearsky_tpu.utils.grids import pressuregrid
    from clearsky_tpu.constants import R_GAS, SIGMA_SB

    G, MU, CP, PS = 9.8, 0.029, 1e3, 1e5
    t0 = time.time()

    nu = np.linspace(100.0, 2200.0, args.nnu)
    co2 = DirectGas.from_lines(
        SpectralLines.from_par(f"{args.par_dir}/CO2.par"), 400e-6, nu
    )
    h2o = DirectGas.from_lines(
        SpectralLines.from_par(f"{args.par_dir}/H2O.par"), 0.01, nu
    )
    print(f"[{time.time()-t0:6.1f}s] gases ready ({args.nnu} wavenumbers)")

    Pe = pressuregrid(50.0, PS, 20)
    Te = np.maximum(280.0 * (Pe / PS) ** (R_GAS / (MU * CP)), 180.0)
    S_tot = 240.0 / np.cos(0.841)  # absorbed ~240 W/m^2 at default zenith
    fS = lambda v: jnp.full(jnp.shape(v), S_tot / (nu[-1] - nu[0]))
    r = RCM.create(
        Pe, Te, G, lambda T, P: MU, fS, 0.0, lambda T, P: CP, 5e5, co2, h2o
    )
    print(f"[{time.time()-t0:6.1f}s] {r!r}")

    r_eq, hist = run(
        r, dt=2e4, nsteps=args.steps, update_every=25,
        adjust_every=1, cp=CP, mu=MU, record_every=max(args.steps // 8, 1),
    )
    jax.block_until_ready(r_eq.T)
    F = radiate_state(r_eq)
    olr = float(F.F_up[0])
    absorbed = float(F.F_down[0])
    Tsurf = float(r_eq.T[-1])
    print(f"[{time.time()-t0:6.1f}s] {args.steps} steps done")
    print(f"  TOA: OLR {olr:8.2f} W/m^2 | absorbed {absorbed:8.2f} W/m^2 "
          f"| imbalance {abs(olr-absorbed)/absorbed*100:.2f}%")
    print(f"  surface temperature {Tsurf:.2f} K "
          f"(bare-rock equilibrium {float((absorbed/SIGMA_SB)**0.25):.2f} K)")
    print("  T(P) profile [K]:")
    for Pc, Tc in zip(np.asarray(r_eq.P)[::4], np.asarray(r_eq.T)[::4]):
        print(f"    {Pc:12.1f} Pa  {Tc:7.2f} K")


if __name__ == "__main__":
    main()
