"""Gas objects: baked opacity tables and direct line-by-line evaluation.

Array-first re-design of the reference's gas layer (ClearSky.jl
``gases.jl:63-386``). The reference stores one Chebyshev interpolator per
wavenumber and pulls scalar cross-sections through closures; here the whole
table is a single coefficient tensor and evaluation at a batch of (T, P)
points is one dense matmul:

    ln_sigma[l, v] = (basis_T[l] (x) basis_lnP[l]) @ coeffs[:, v]

Two operating modes, both matching reference capability:

* :class:`Gas` — *table mode*: cross-sections baked once on the
  AtmosphericDomain grid (ref ``bake``, gases.jl:97-145) with the block-banded
  line-sum kernel, then evaluated by Chebyshev tensor contraction
  (the ``OpacityTable`` equivalent, ref gases.jl:66-85).
* :class:`DirectGas` — *direct mode*: cross-sections recomputed from lines at
  every evaluation. The reference cannot afford this on CPU; an accelerator
  can, and it removes all interpolation error.

Plus the analytic absorbers :class:`GrayGas` and :class:`SemiGrayGas`
(ref gases.jl:340-386) used by the analytic test suite.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import jax
import jax.numpy as jnp

from ..utils.interp import cheb2d_coeffs, cheb_basis
from ..ops.linesum import (
    LineWindowPlan,
    build_line_window_plan,
    sigma_from_lines,
    sigma_from_lines_auto,
    DEFAULT_CUT,
)
from ..backend import device_bake
from ..spectra.lines import SpectralLines
from .domain import AtmosphericDomain

__all__ = [
    "AbstractGas",
    "Gas",
    "DirectGas",
    "GrayGas",
    "SemiGrayGas",
    "MultiGas",
    "WellMixedGas",
    "VariableGas",
    "bake_sigma_grid",
    "opacity_error",
    "as_concentration",
]

_LOG_TINY = float(np.log(np.finfo(np.float64).tiny))  # ref gases.jl:76-79


def _check_nu(nu) -> np.ndarray:
    """Validate a wavenumber grid: positive, unique, ascending (ref gases.jl:104)."""
    nu = np.asarray(nu, dtype=np.float64)
    if nu.ndim != 1 or len(nu) < 2:
        raise ValueError("wavenumber grid must be a 1-D vector of at least 2 points")
    if np.any(nu <= 0) or np.any(np.diff(nu) <= 0):
        raise ValueError(
            "wavenumbers must be positive, unique, and in ascending order "
            "(negative wavenumbers silently poison the Planck function)"
        )
    return nu


def as_concentration(fC) -> Callable:
    """Normalize a concentration spec (scalar or fC(T, P)) to a callable."""
    if callable(fC):
        return fC
    c = float(fC)
    if not (0.0 <= c <= 1.0):
        raise ValueError(f"gas molar concentration must be in [0,1], not {c}")
    return lambda T, P: jnp.full(jnp.shape(jnp.asarray(T) * jnp.asarray(P)), c)


class AbstractGas:
    """Interface: ``raw_sigma(T, P) -> [..., n_nu]`` and concentration scaling."""

    def raw_sigma(self, T, P):  # pragma: no cover - interface
        raise NotImplementedError

    def concentration(self, T, P):
        """Molar concentration [mole/mole]. Ref gases.jl:270."""
        return self.fC(T, P)

    def __call__(self, T, P):
        """Concentration-scaled cross-sections [..., n_nu]. Ref gases.jl:278-281."""
        C = jnp.asarray(self.concentration(T, P))
        return C[..., None] * self.raw_sigma(T, P)


def bake_sigma_grid(
    lines: SpectralLines,
    fC,
    nu: np.ndarray,
    domain: AtmosphericDomain,
    shape: str = "voigt",
    cut: float | None = None,
    block: int = 128,
    tp_batch: int = 16,
    backend: str = "auto",
    device_out: bool = False,
) -> np.ndarray:
    """Fill the sigma[nT, nP, n_nu] cross-section grid (the reference's ``bake``).

    Ref gases.jl:97-145. Evaluates the line-sum kernel at every (T, P) node of
    the domain — jit-compiled and batched over ``tp_batch`` nodes at a time —
    and applies the reference's mixed-zero underflow cleanup
    (ref gases.jl:132-142): wavenumbers where zero and nonzero values mix
    across the grid are zeroed everywhere.

    ``backend``: 'auto' (the implementation ``clearsky_tpu.backend``
    selects — the default) or 'oracle' (force the plain jnp path at ambient
    precision). ``device_out=True`` keeps the grid on the device (a jax
    array) instead of returning a numpy array.
    """
    cut = DEFAULT_CUT[shape] if cut is None else float(cut)
    fC = as_concentration(fC)
    nu = _check_nu(nu)
    plan = build_line_window_plan(nu, np.asarray(lines.nu), cut, block=block)
    if backend == "auto":
        eval_fn = sigma_from_lines_auto
    elif backend == "oracle":
        eval_fn = sigma_from_lines
    else:
        raise ValueError("backend must be 'auto' or 'oracle'")
    TT, PP = np.meshgrid(domain.T, domain.P, indexing="ij")
    Tf, Pf = TT.ravel(), PP.ravel()
    Cf = np.asarray(jax.vmap(fC)(jnp.asarray(Tf), jnp.asarray(Pf)))
    if np.any((Cf < 0) | (Cf > 1)):
        bad = int(np.argmax((Cf < 0) | (Cf > 1)))
        raise ValueError(
            f"gas molar concentrations must be in [0,1], not {Cf[bad]} "
            f"(encountered @ {Tf[bad]} K, {Pf[bad]} Pa)"
        )
    # progress via stdlib logging (the reference shows a ProgressMeter during
    # bake, ref gases.jl:112-115): silent unless the caller configures the
    # 'clearsky_tpu' logger — library code must not print unasked
    import logging
    import time as _time

    log = logging.getLogger(__name__)
    t_bake = _time.perf_counter()
    log.info(
        "baking sigma grid: %d (T,P) nodes x %d wavenumbers, %d lines (%s)",
        len(Tf), len(nu), lines.nu.shape[0], shape,
    )
    chunks = []
    for a in range(0, len(Tf), tp_batch):
        b = min(a + tp_batch, len(Tf))
        chunk = eval_fn(
            plan,
            lines,
            jnp.asarray(Tf[a:b]),
            jnp.asarray(Pf[a:b]),
            jnp.asarray(Cf[a:b] * Pf[a:b]),
            shape,
        )
        # device_out: keep every batch ON DEVICE — a production-scale table
        # ([288, 2^19] f32 ~ 600 MB) need not cross to the host and back
        chunks.append(chunk if device_out else np.asarray(chunk))
        log.debug("  baked nodes %d-%d / %d", a, b, len(Tf))
    log.info("bake done in %.2f s", _time.perf_counter() - t_bake)
    if device_out:
        sigma = jnp.concatenate(chunks).reshape(domain.nT, domain.nP, len(nu))
        smin = sigma.min(axis=(0, 1))
        smax = sigma.max(axis=(0, 1))
        mixed = (smin == 0.0) & (smax > 0.0)
        return jnp.where(mixed[None, None, :], 0.0, sigma)
    sigma = np.concatenate(chunks).reshape(domain.nT, domain.nP, len(nu))
    # mixed-zero underflow cleanup (ref gases.jl:132-142)
    smin = sigma.min(axis=(0, 1))
    smax = sigma.max(axis=(0, 1))
    mixed = (smin == 0.0) & (smax > 0.0)
    if mixed.any():
        sigma[:, :, mixed] = 0.0
    return sigma


# Per-column dynamic-range clip applied to ln(sigma) before the Chebyshev
# fit: ln is floored at max(column max - LN_CLIP, LN_F32_FLOOR), i.e. values
# below 1e-20 of the column's own peak — and in every case values below the
# f32 underflow boundary — are flattened to that floor. DELIBERATE DEVIATION
# from the reference, which floors at the absolute log(floatmin)
# (ref gases.jl:75-82): a mixed-precision robustness guard (the precision of
# the evaluation matmul is a separate matter, see raw_sigma below and
# utils/interp.cheb2d_coeffs). Under an f32
# bake, far-wing sigma that underflows to 0 at cold/low-P corner nodes
# would otherwise be floored at log(floatmin), and a -708-vs--40 cliff
# makes the GLOBAL Chebyshev fit of that column ring across the whole
# (T, P) domain. Clipping at 1e-20 of the column peak bounds the fit's
# dynamic range while distorting only values >= 12 decades below radiative
# relevance (the error masks use 1e-8 of peak); the LN_F32_FLOOR leg keeps
# the floor AT the underflow boundary for weak columns, so f32-zeroed nodes
# land near their true (sub-underflow) values instead of 600+ log units
# away. All-zero columns are unaffected (flat at log(floatmin), as
# upstream). Measured effect on the production worst columns: none (their
# node ranges span only 5-7 decades); kept as armor for colder/lower-P
# domains where corner underflow is real.
LN_CLIP = float(np.log(1e20))
LN_F32_FLOOR = float(np.log(np.finfo(np.float32).tiny))  # ~ -87.34


def _ln_sigma_coeffs_device(sigma, domain: AtmosphericDomain):
    """Device-resident twin of :func:`_ln_sigma_coeffs`: same log floors and
    all-zero handling, but jnp end to end (one jit, no host transfer)."""

    @jax.jit
    def fit(sig):
        tiny = jnp.finfo(sig.dtype).tiny
        ln = jnp.where(sig > 0.0, jnp.log(jnp.maximum(sig, tiny)), _LOG_TINY)
        allzero = (sig <= tiny).all(axis=(0, 1))
        peak = ln.max(axis=(0, 1), keepdims=True)
        # guard the floor at the column peak: a (non-all-zero) column whose
        # peak already sits below LN_F32_FLOOR must not be raised wholesale
        # to the f32-tiny level (tens of orders above its true values)
        floor = jnp.minimum(peak, jnp.maximum(peak - LN_CLIP, LN_F32_FLOOR))
        ln = jnp.where(allzero[None, None, :], _LOG_TINY,
                       jnp.maximum(ln, floor))
        coeffs = cheb2d_coeffs(jnp.moveaxis(ln, -1, 0))  # [n_nu, nT, nP]
        nT, nP = sig.shape[0], sig.shape[1]
        return jnp.moveaxis(coeffs.reshape(-1, nT * nP), 0, -1)

    return fit(jnp.asarray(sigma))


def _ln_sigma_coeffs(sigma: np.ndarray, domain: AtmosphericDomain) -> np.ndarray:
    """Chebyshev coefficients of ln(sigma) over (T, lnP), flattened to [nT*nP, n_nu].

    All-zero wavenumbers are stored as the constant log(floatmin), matching the
    reference's OpacityTable (ref gases.jl:75-82); see LN_CLIP above for the
    per-column dynamic-range floor (deliberate deviation, measured).
    """
    ln = np.where(sigma > 0.0, np.log(np.maximum(sigma, np.finfo(np.float64).tiny)), _LOG_TINY)
    allzero = (sigma <= np.finfo(np.float64).tiny).all(axis=(0, 1))
    peak = ln.max(axis=(0, 1), keepdims=True)
    # floor never exceeds the column's own peak (see device twin above)
    floor = np.minimum(peak, np.maximum(peak - LN_CLIP, LN_F32_FLOOR))
    ln = np.maximum(ln, floor)
    ln[:, :, allzero] = _LOG_TINY
    coeffs = np.asarray(cheb2d_coeffs(jnp.asarray(np.moveaxis(ln, -1, 0))))  # [n_nu, nT, nP]
    nT, nP = sigma.shape[0], sigma.shape[1]
    return np.moveaxis(coeffs.reshape(-1, nT * nP), 0, -1)  # [nT*nP, n_nu]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True, eq=False)
class Gas(AbstractGas):
    """Baked-table gas absorber. Ref gases.jl:180-336.

    ``coeffs`` holds Chebyshev coefficients of ln(sigma) over (T, lnP) for all
    wavenumbers; evaluation is a dense [L, nT*nP] x [nT*nP, n_nu] contraction.
    """

    nu: jax.Array                 # [n_nu]
    coeffs: jax.Array             # [nT*nP, n_nu] (full) or [K, n_nu] (split lead)
    name: str = dataclasses.field(metadata=dict(static=True), default="")
    formula: str = dataclasses.field(metadata=dict(static=True), default="")
    mu: float = dataclasses.field(metadata=dict(static=True), default=float("nan"))
    domain: AtmosphericDomain = dataclasses.field(
        metadata=dict(static=True), default=None
    )
    fC: Callable = dataclasses.field(metadata=dict(static=True), default=None)
    # split-precision storage: the K magnitude-carrying coefficients stay
    # f32 in ``coeffs`` (rows = ``lead_idx``), the remaining nT*nP-K ride
    # bfloat16 in ``coeffs_tail`` (rows = ``tail_idx``) with f32
    # accumulation at eval — 0.53x the device-memory bytes of the full-f32 tensor, the dominant byte term of the production
    # table pipeline. See ``split_precision`` for the accuracy contract.
    coeffs_tail: jax.Array | None = None   # [nT*nP-K, n_nu] bf16
    lead_idx: tuple = dataclasses.field(metadata=dict(static=True), default=None)
    tail_idx: tuple = dataclasses.field(metadata=dict(static=True), default=None)

    @classmethod
    def from_lines(
        cls,
        lines: SpectralLines,
        fC,
        nu,
        domain: AtmosphericDomain,
        shape: str = "voigt",
        cut: float | None = None,
        dtype=None,
        **bake_kwargs,
    ) -> "Gas":
        """Bake a gas from spectral lines. Ref gases.jl:225-238."""
        if device_bake() and "backend" not in bake_kwargs:
            # keep the whole bake -> log -> Chebyshev-fit pipeline on the
            # device: the production sigma grid (~600 MB at 2^19 points)
            # never goes through the host
            sigma = bake_sigma_grid(
                lines, fC, nu, domain, shape=shape, cut=cut,
                device_out=True, **bake_kwargs,
            )
            coeffs = _ln_sigma_coeffs_device(sigma, domain)
        else:
            sigma = bake_sigma_grid(
                lines, fC, nu, domain, shape=shape, cut=cut, **bake_kwargs
            )
            coeffs = _ln_sigma_coeffs(sigma, domain)
        dtype = dtype or jnp.asarray(1.0).dtype
        return cls(
            nu=jnp.asarray(np.asarray(nu), dtype=dtype),
            coeffs=jnp.asarray(coeffs, dtype=dtype),
            name=lines.name,
            formula=lines.formula,
            mu=lines.mean_molar_mass,
            domain=domain,
            fC=as_concentration(fC),
        )

    @classmethod
    def from_par(cls, filename: str, fC, nu, domain, shape="voigt", cut=None, **kwargs):
        """Read a .par file and bake directly. Ref gases.jl:240-249."""
        bake_keys = {"block", "tp_batch", "dtype", "backend"}
        bk = {k: kwargs.pop(k) for k in list(kwargs) if k in bake_keys}
        lines = SpectralLines.from_par(filename, **kwargs)
        return cls.from_lines(lines, fC, nu, domain, shape=shape, cut=cut, **bk)

    def raw_sigma(self, T, P):
        """Cross-sections [..., n_nu] without concentration scaling. Ref gases.jl:256-263."""
        T = jnp.asarray(T)
        P = jnp.asarray(P)
        shp = jnp.broadcast_shapes(T.shape, P.shape)
        Tq = jnp.broadcast_to(T, shp).reshape(-1)
        Pq = jnp.broadcast_to(P, shp).reshape(-1)
        d = self.domain
        BT = cheb_basis(Tq, d.Tmin, d.Tmax, d.nT)                       # [L, nT]
        BP = cheb_basis(jnp.log(Pq), np.log(d.Pmin), np.log(d.Pmax), d.nP)  # [L, nP]
        basis = (BT[:, :, None] * BP[:, None, :]).reshape(Tq.shape[0], -1)
        # The precision pin is load-bearing. ln(sigma) has magnitudes ~50-90,
        # so a relative error e on it becomes ~70 e absolute in ln and
        # exp(70 e) - 1 in sigma: 0.4% gives 20-75%. A default-precision or
        # Precision.HIGH f32 matmul runs in TF32 on the GPU (10 mantissa
        # bits, ~5e-4 relative), which puts sigma off by percents with no
        # error raised. HIGHEST keeps the contraction in full f32; the
        # remaining error is f32 roundoff, far below the Chebyshev fit's
        # own ~1% error class.
        if self.coeffs_tail is None:
            ln = jnp.matmul(basis, self.coeffs,
                            precision=jax.lax.Precision.HIGHEST)  # [L, n_nu]
            return jnp.exp(ln).reshape(shp + (self.coeffs.shape[-1],))
        # split-precision path: the lead rows keep the full-f32 contraction
        # above (they carry the ~50-90-magnitude ln values); the bf16 tail's
        # coefficients are small (Chebyshev decay), so one bf16 matmul with
        # f32 accumulation holds the quantization error at
        # ~2e-3 * sum|c_tail| <~ 1e-2 in ln worst case — measured 1.1e-3 max
        # sigma rel at K=16 on a CO2 bake, 10x below the fit's own error.
        acc = self.coeffs.dtype
        b_lead = jnp.take(basis, jnp.asarray(np.asarray(self.lead_idx)), axis=1)
        b_tail = jnp.take(basis, jnp.asarray(np.asarray(self.tail_idx)), axis=1)
        ln = jnp.matmul(b_lead.astype(acc), self.coeffs,
                        precision=jax.lax.Precision.HIGHEST)
        ln = ln + jnp.matmul(b_tail.astype(jnp.bfloat16), self.coeffs_tail,
                             preferred_element_type=acc)
        return jnp.exp(ln).reshape(shp + (self.coeffs.shape[-1],))

    def split_precision(self, k: int = 16) -> "Gas":
        """Re-store the coefficient tensor in split precision (f32 lead +
        bf16 tail), keeping evaluation semantics.

        The ``k`` flattened (T, P)-node coefficients with the largest
        max-over-nu magnitude stay in the working dtype; the rest are
        rounded to bfloat16 and accumulated at f32 during evaluation.
        Accuracy (CO2 fixture, 12 T x 24 P domain, dense (T, P) probe):
        max sigma rel error vs the full table 2.9e-3 / 1.1e-3 / 6.0e-4 at
        k = 8 / 16 / 32 — all far inside the table's intrinsic ~1.3e-2
        production fit class. Device-memory bytes: 0.51x / 0.53x / 0.56x of
        full f32.
        """
        if self.coeffs_tail is not None:
            raise ValueError("gas is already split-precision")
        nc = self.coeffs.shape[0]
        if not (0 < k < nc):
            raise ValueError(f"k must be in (0, {nc}), not {k}")
        score = np.abs(np.asarray(self.coeffs)).max(axis=1)
        order = np.argsort(-score)
        lead = np.sort(order[:k])
        tail = np.sort(order[k:])
        return dataclasses.replace(
            self,
            coeffs=self.coeffs[lead],
            coeffs_tail=self.coeffs[tail].astype(jnp.bfloat16),
            lead_idx=tuple(int(i) for i in lead),
            tail_idx=tuple(int(i) for i in tail),
        )

    def reconcentrate(self, fC) -> "Gas":
        """New Gas with a different concentration function/value.

        Like the reference (ref gases.jl:292-320), self-broadening baked into
        the table is NOT recomputed — acceptable when partial pressure is low.
        """
        fC = as_concentration(fC)
        # validate on the domain grid (ref gases.jl:294-301)
        TT, PP = np.meshgrid(self.domain.T, self.domain.P, indexing="ij")
        C = np.asarray(jax.vmap(fC)(jnp.asarray(TT.ravel()), jnp.asarray(PP.ravel())))
        if np.any((C < 0) | (C > 1)):
            raise ValueError("gas molar concentrations must be in [0,1]")
        return dataclasses.replace(self, fC=fC)

    def select(self, idx) -> "Gas":
        """Slice the gas to a subset of its wavenumbers (indices or bool mask).

        Ref gases.jl:322-336 (``getindex`` on a Gas).
        """
        idx = np.asarray(idx)
        return dataclasses.replace(
            self, nu=self.nu[idx], coeffs=self.coeffs[:, idx],
            coeffs_tail=None if self.coeffs_tail is None
            else self.coeffs_tail[:, idx],
        )

    def __repr__(self):  # pragma: no cover - cosmetic
        return f"Gas({self.name} [{self.formula}], n_nu={self.nu.shape[0]}, mu={self.mu:.6g})"


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True, eq=False)
class DirectGas(AbstractGas):
    """Direct line-by-line gas: cross-sections recomputed from lines per call.

    No reference equivalent (the reference must bake, ref gases.jl:97); this is
    the accelerator-first mode — zero interpolation error, with the line-sum
    kernel as the hot loop.
    """

    lines: SpectralLines
    nu: jax.Array
    plan: LineWindowPlan = dataclasses.field(metadata=dict(static=True), default=None)
    shape: str = dataclasses.field(metadata=dict(static=True), default="voigt")
    fC: Callable = dataclasses.field(metadata=dict(static=True), default=None)
    name: str = dataclasses.field(metadata=dict(static=True), default="")
    formula: str = dataclasses.field(metadata=dict(static=True), default="")
    mu: float = dataclasses.field(metadata=dict(static=True), default=float("nan"))

    @classmethod
    def from_lines(
        cls, lines, fC, nu, shape: str = "voigt", cut: float | None = None,
        block: int = 128,
    ) -> "DirectGas":
        """Direct gas from spectral lines on the wavenumber grid ``nu``."""
        cut = DEFAULT_CUT[shape] if cut is None else float(cut)
        nu = _check_nu(nu)
        plan = build_line_window_plan(nu, np.asarray(lines.nu), cut, block=block)
        return cls(
            lines=lines,
            nu=jnp.asarray(nu),
            plan=plan,
            shape=shape,
            fC=as_concentration(fC),
            name=lines.name,
            formula=lines.formula,
            mu=lines.mean_molar_mass,
        )

    def raw_sigma(self, T, P):
        T = jnp.asarray(T)
        P = jnp.asarray(P)
        C = jnp.asarray(self.fC(T, P))
        return sigma_from_lines_auto(self.plan, self.lines, T, P, C * P,
                                     self.shape)

    def reconcentrate(self, fC) -> "DirectGas":
        """New DirectGas with different concentration — self-broadening IS
        recomputed here (unlike table mode), since evaluation is direct."""
        return dataclasses.replace(self, fC=as_concentration(fC))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True, eq=False)
class GrayGas(AbstractGas):
    """Constant cross-section absorber. Ref gases.jl:340-360."""

    nu: jax.Array
    sigma: float = dataclasses.field(metadata=dict(static=True), default=0.0)
    name: str = dataclasses.field(metadata=dict(static=True), default="Gray")
    formula: str = dataclasses.field(metadata=dict(static=True), default="Gray")
    mu: float = dataclasses.field(metadata=dict(static=True), default=float("nan"))

    @classmethod
    def create(cls, sigma: float, nu) -> "GrayGas":
        return cls(nu=jnp.asarray(_check_nu(nu)), sigma=float(sigma))

    def raw_sigma(self, T, P):
        shp = jnp.broadcast_shapes(jnp.shape(T), jnp.shape(P))
        return jnp.full(shp + (self.nu.shape[0],), self.sigma, dtype=self.nu.dtype)

    def concentration(self, T, P):
        return jnp.ones(jnp.broadcast_shapes(jnp.shape(T), jnp.shape(P)))

    @property
    def fC(self):
        return lambda T, P: jnp.ones(jnp.broadcast_shapes(jnp.shape(T), jnp.shape(P)))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True, eq=False)
class SemiGrayGas(AbstractGas):
    """Gray absorber active only for nu <= nucut. Ref gases.jl:364-386."""

    nu: jax.Array
    sigma: float = dataclasses.field(metadata=dict(static=True), default=0.0)
    nucut: float = dataclasses.field(metadata=dict(static=True), default=0.0)
    name: str = dataclasses.field(metadata=dict(static=True), default="SemiGray")
    formula: str = dataclasses.field(metadata=dict(static=True), default="SemiGray")
    mu: float = dataclasses.field(metadata=dict(static=True), default=float("nan"))

    @classmethod
    def create(cls, sigma: float, nu, nucut: float) -> "SemiGrayGas":
        return cls(
            nu=jnp.asarray(_check_nu(nu)),
            sigma=float(sigma),
            nucut=float(nucut),
        )

    def raw_sigma(self, T, P):
        shp = jnp.broadcast_shapes(jnp.shape(T), jnp.shape(P))
        row = jnp.where(self.nu <= self.nucut, self.sigma, 0.0)
        return jnp.broadcast_to(row, shp + (self.nu.shape[0],))

    def concentration(self, T, P):
        return jnp.ones(jnp.broadcast_shapes(jnp.shape(T), jnp.shape(P)))

    @property
    def fC(self):
        return lambda T, P: jnp.ones(jnp.broadcast_shapes(jnp.shape(T), jnp.shape(P)))


def opacity_error(
    gas: Gas,
    lines: SpectralLines,
    nu_index: int,
    shape: str = "voigt",
    cut: float | None = None,
    N: int = 50,
):
    """Interpolation-accuracy harness: table vs exact line-sum on a dense T x P grid.

    Ref gases.jl:152-175. Returns (T, P, abs_err, rel_err) with err of shape [N, N].
    """
    d = gas.domain
    T = np.linspace(d.Tmin, d.Tmax, N)
    P = 10 ** np.linspace(np.log10(d.Pmin), np.log10(d.Pmax), N)
    TT, PP = np.meshgrid(T, P, indexing="ij")
    Tf = jnp.asarray(TT.ravel())
    Pf = jnp.asarray(PP.ravel())
    approx = np.asarray(gas.raw_sigma(Tf, Pf)[:, nu_index]).reshape(N, N)
    cutv = DEFAULT_CUT[shape] if cut is None else float(cut)
    nu_val = float(np.asarray(gas.nu)[nu_index])
    plan = build_line_window_plan(np.array([nu_val]), np.asarray(lines.nu), cutv, block=8)
    C = jnp.asarray(jax.vmap(gas.fC)(Tf, Pf))
    exact = np.asarray(
        sigma_from_lines(plan, lines, Tf, Pf, C * Pf, shape)
    ).reshape(N, N)
    aerr = approx - exact
    rerr = aerr / np.where(exact == 0, np.nan, exact)
    return T, P, aerr, rerr


def WellMixedGas(filename, C, nu, domain, **kwargs) -> Gas:
    """Baked gas with a constant molar concentration.

    Parity alias for the reference docs' ``WellMixedGas`` (docs/src/
    gas_objects.md; the upstream source itself folded it into ``Gas`` with a
    constant-concentration closure).
    """
    if not (0.0 <= float(C) <= 1.0):
        raise ValueError("well-mixed concentration must be in [0,1]")
    return Gas.from_par(filename, float(C), nu, domain, **kwargs)


def VariableGas(filename, fC, nu, domain, **kwargs) -> Gas:
    """Baked gas with a temperature/pressure-dependent concentration fC(T, P).

    Parity alias for the reference docs' ``VariableGas``.
    """
    if not callable(fC):
        raise TypeError("VariableGas requires a callable fC(T, P)")
    return Gas.from_par(filename, fC, nu, domain, **kwargs)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True, eq=False)
class GasComponent:
    """Lightweight per-molecule view of a fused MultiGas: formula +
    concentration only — exactly what CIA pairing needs (partial pressures
    come from stored concentration functions, ref
    collision_induced_absorption.jl:431-465). No spectral data; never
    evaluated as an absorber."""

    formula: str = dataclasses.field(metadata=dict(static=True), default="")
    name: str = dataclasses.field(metadata=dict(static=True), default="")
    fC: Callable = dataclasses.field(metadata=dict(static=True), default=None)

    def concentration(self, T, P):
        return self.fC(T, P)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True, eq=False)
class MultiGas(AbstractGas):
    """Fused multi-molecule direct gas: one merged catalog, one kernel pass.

    Merges several molecules' line catalogs so a whole gas mixture evaluates
    in a single line-sum kernel launch — N separate ``DirectGas`` objects cost
    N launches over overlapping wavenumber windows. No reference equivalent.

    Concentrations may be fixed scalars (folded per line at construction,
    ``conc``) or callables fC(T, P) (full ``Gas``-level generality, ref
    gases.jl:278): with callables, per-line concentrations [..., n_lines] are
    gathered from the per-molecule fC values through ``mol_ptr`` at every
    evaluation, feeding both the intensity scaling and the self-broadening
    partial pressure.

    Carries a combined formula, but CIA auto-pairing still works: pairing
    matches against the per-molecule :class:`GasComponent` views from
    :meth:`components` (formula + concentration are all the amagat
    conversion needs).
    """

    lines: object
    conc: jax.Array | None   # [n_lines] fixed per-line concentration, or None
    nu: jax.Array
    mol_ptr: jax.Array | None = None  # [n_lines] entry index (callable mode)
    plan: LineWindowPlan = dataclasses.field(metadata=dict(static=True), default=None)
    shape: str = dataclasses.field(metadata=dict(static=True), default="voigt")
    fCs: tuple = dataclasses.field(metadata=dict(static=True), default=())
    formulas: tuple = dataclasses.field(metadata=dict(static=True), default=())
    names: tuple = dataclasses.field(metadata=dict(static=True), default=())
    name: str = dataclasses.field(metadata=dict(static=True), default="")
    formula: str = dataclasses.field(metadata=dict(static=True), default="")
    mu: float = dataclasses.field(metadata=dict(static=True), default=float("nan"))

    @classmethod
    def from_lines(
        cls, entries, nu, shape: str = "voigt", cut: float | None = None,
        block: int = 128,
    ) -> "MultiGas":
        """Build from [(SpectralLines, concentration-or-fC), ...]."""
        from ..spectra.merge import merge_lines, merge_catalogs

        cut = DEFAULT_CUT[shape] if cut is None else float(cut)
        nu = _check_nu(nu)
        fCs = tuple(as_concentration(c) for _, c in entries)
        if any(callable(c) for _, c in entries):
            merged, mol_ptr = merge_catalogs([l for l, _ in entries])
            conc = None
        else:
            merged, conc = merge_lines(entries)
            mol_ptr = None
        plan = build_line_window_plan(nu, np.asarray(merged.nu), cut, block=block)
        return cls(
            lines=merged,
            conc=conc,
            nu=jnp.asarray(nu),
            mol_ptr=mol_ptr,
            plan=plan,
            shape=shape,
            fCs=fCs,
            formulas=tuple(l.formula for l, _ in entries),
            names=tuple(l.name for l, _ in entries),
            name=merged.name,
            formula=merged.formula,
            mu=merged.mean_molar_mass,
        )

    def components(self) -> tuple:
        """Per-molecule :class:`GasComponent` views (for CIA auto-pairing)."""
        return tuple(
            GasComponent(formula=f, name=n, fC=c)
            for f, n, c in zip(self.formulas, self.names, self.fCs)
        )

    def _conc(self, T, P):
        """Per-line concentration array ([n_lines] or [..., n_lines])."""
        if self.mol_ptr is not None:
            cs = jnp.stack(
                [jnp.asarray(f(T, P)) for f in self.fCs], axis=-1
            )  # [..., n_mols]
            return jnp.take(cs, self.mol_ptr.astype(jnp.int32), axis=-1)
        return self.conc

    def raw_sigma(self, T, P):
        """Mixture cross-section [..., n_nu] — already concentration-scaled."""
        T = jnp.asarray(T)
        P = jnp.asarray(P)
        return sigma_from_lines_auto(
            self.plan, self.lines, T, P, None, self.shape, conc=self._conc(T, P),
        )

    def concentration(self, T, P):
        """Unity: concentrations are folded per line inside the kernel."""
        return jnp.ones(jnp.broadcast_shapes(jnp.shape(T), jnp.shape(P)))

    @property
    def fC(self):
        return lambda T, P: jnp.ones(jnp.broadcast_shapes(jnp.shape(T), jnp.shape(P)))
