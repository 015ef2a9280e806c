"""Execute the fenced ``python`` code blocks of docs/*.md (the docs check).

The reference CI runs a Documenter doctest job
(/root/reference/.github/workflows/CI.yml:42-61); this is the equivalent for
the markdown docs here: every ```python block is executed, per file, in one
cumulative namespace pre-seeded with small fixture objects (Documenter's
doctest-setup pattern) — so renamed/removed APIs make the nightly CI fail
instead of silently rotting the docs.

Blocks run on CPU with tiny shapes (fixture catalogs truncated to 200 lines,
512-point grids) inside a temp dir that symlinks the HITRAN fixtures, so
relative paths like "CO2.par" in the prose resolve.

Run: python scripts/run_doc_examples.py  [docs/file.md ...]
Exit code 0 = every block ran.
"""

import glob
import os
import re
import sys
import tempfile
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
FIXTURES = "/root/reference/test/HITRAN"

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def make_namespace():
    """The doctest-setup namespace: every free variable the doc snippets use,
    built at toy scale. Keep in sync with docs/*.md prose."""
    import numpy as np
    import jax.numpy as jnp
    import clearsky_tpu as ct

    ns = {"np": np, "jnp": jnp}
    # spectral fixtures (tiny)
    lines = ct.SpectralLines.from_par(f"{FIXTURES}/CO2.par", maxlines=200)
    h2o_lines = ct.SpectralLines.from_par(f"{FIXTURES}/H2O.par", maxlines=200)
    nu_l = np.asarray(lines.nu)
    nu = np.linspace(max(nu_l.min() - 25.0, 1.0), nu_l.max() + 25.0, 512)
    T = jnp.asarray([250.0, 280.0])
    P = jnp.asarray([1e3, 1e4])
    ns.update(
        lines=lines, co2_lines=lines, h2o_lines=h2o_lines,
        nu=nu, nu_grid=nu, lines_nu=nu_l,
        T=T, P=P, Pp=0.95 * P,
        fC=lambda T, P: 0.01 * jnp.ones(jnp.broadcast_shapes(jnp.shape(T), jnp.shape(P))),
        psat_fraction=lambda T, P: 0.01 * jnp.ones(jnp.broadcast_shapes(jnp.shape(T), jnp.shape(P))),
    )
    # column fixtures
    from clearsky_tpu.utils.grids import pressuregrid
    from clearsky_tpu.constants import R_GAS

    G, MU, CP, PS, PT = 9.8, 0.044, 850.0, 1e5, 10.0
    Pe = pressuregrid(PT, PS, 8)
    Te = np.maximum(280.0 * (Pe / PS) ** (R_GAS / (MU * CP)), 150.0)
    gas = ct.DirectGas.from_lines(lines, 0.95, nu)
    rcm = ct.RCM.create(
        Pe, Te, G, lambda T, P: MU, 0.0, 0.0, lambda T, P: CP, 1e7, gas
    )
    ns.update(
        Pe=Pe, Te=Te, g=G, fmu=lambda T, P: MU, fS=0.0, fa=0.0,
        fcp=lambda T, P: CP, cs=1e7, cp=CP, mu=MU,
        absorbers=(gas,), rcm=rcm, dt=300.0, nsteps=2,
        Discretized=ct.Discretized,
    )
    # public package surface for bare imports in snippets
    ns.update({k: getattr(ct, k) for k in dir(ct) if not k.startswith("_")})
    return ns


def blocks_of(path):
    txt = open(path).read()
    for m in re.finditer(r"```python\n(.*?)```", txt, re.S):
        yield txt[: m.start()].count("\n") + 2, m.group(1)


def main(paths):
    if not os.path.isdir(FIXTURES):
        # CI runners without the reference checkout skip gracefully
        # (mirrors tests/conftest.py's fixtures_dir skip)
        print(f"skip: fixtures not available at {FIXTURES}")
        return 0
    from clearsky_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    paths = paths or sorted(glob.glob(os.path.join(ROOT, "docs", "*.md")))
    failures = 0
    with tempfile.TemporaryDirectory() as td:
        for name in ("CO2.par", "H2O.par", "CO2-CO2_2018.cia", "CO2-CH4_2018.cia"):
            src = os.path.join(FIXTURES, name)
            if os.path.exists(src):
                os.symlink(src, os.path.join(td, name))
        cwd = os.getcwd()
        os.chdir(td)
        try:
            for path in paths:
                ns = make_namespace()
                # docs reference full-catalog bakes; keep the doc text honest
                # but the check fast by truncating .par reads inside blocks
                import clearsky_tpu as ct

                orig_from_par = ct.SpectralLines.from_par.__func__

                def small_from_par(cls, fn, **kw):
                    kw.setdefault("maxlines", 200)
                    return orig_from_par(cls, fn, **kw)

                ct.SpectralLines.from_par = classmethod(small_from_par)
                try:
                    for lineno, code in blocks_of(path):
                        try:
                            exec(compile(code, f"{path}:{lineno}", "exec"), ns)
                        except Exception:
                            failures += 1
                            print(f"FAIL {os.path.relpath(path, ROOT)}:{lineno}")
                            traceback.print_exc(limit=3)
                    print(f"ok   {os.path.relpath(path, ROOT)}")
                finally:
                    ct.SpectralLines.from_par = classmethod(orig_from_par)
        finally:
            os.chdir(cwd)
    if failures:
        print(f"{failures} doc block(s) failed")
        return 1
    print("all doc blocks ran")
    return 0


if __name__ == "__main__":
    sys.exit(main([os.path.abspath(p) for p in sys.argv[1:]]))
