"""Branch-free Faddeeva function for Voigt profiles.

The reference evaluates Voigt profiles through ``Faddeyeva985.faddeyeva(x, y)``
(Zaghloul's ACM TOMS Algorithm 985 class, ~1e-4..1e-5 relative accuracy; call
site ClearSky.jl ``line_shapes.jl:375``). Scalar region-based branching is
hostile to wide vector units, so this module implements Humlicek's w4
rational-region algorithm with *all four regions evaluated branch-free* and
combined with ``jnp.where`` — pure elementwise arithmetic, no complex dtype,
no data-dependent control flow. The same real-pair arithmetic is reused
verbatim inside the GPU line-sum kernel.

The classic w4 weakness — catastrophic cancellation in Re w as y -> 0 near
the line-core region — is repaired with a second-order Taylor expansion off
the real axis (exact e^{-x^2} at y = 0) switched in below y = 0.01.

Accuracy: <= 2.4e-4 relative (worst point; 99.8% of the upper half plane
better than 1e-4) in float64, validated against scipy.special.wofz in tests —
the same accuracy class as the reference's Algorithm-985 dependency.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["wofz_re", "wofz_re_im", "wofz_re_kernel"]

_SQRT_PI = 1.7724538509055159
_Y_SMALL = 0.01  # switch to the Taylor-off-axis real part below this y


def _cmul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def _cdiv(ar, ai, br, bi):
    # NOTE: must stay in the two-division form. The tempting single-reciprocal
    # rewrite (inv = 1/(br^2+bi^2)) overflows |d|^2 to inf in float32 for the
    # far-wing arguments of wide-cut line sums (|z| ~ 1e5 -> |d|^2 ~ 1e46),
    # silently zeroing the profile tails.
    d = br * br + bi * bi
    return (ar * br + ai * bi) / d, (ai * br - ar * bi) / d


def _cpoly(coeffs, tr, ti):
    """Horner evaluation of a real-coefficient polynomial at complex t."""
    pr = jnp.zeros_like(tr) + coeffs[0]
    pi = jnp.zeros_like(tr)
    for c in coeffs[1:]:
        pr, pi = _cmul(pr, pi, tr, ti)
        pr = pr + c
    return pr, pi


def _wofz_re_im_impl(x, y):
    """Real and imaginary parts of w(z) = exp(-z^2) erfc(-iz) for z = x + iy, y >= 0.

    Humlicek (1982) w4 algorithm, evaluated branch-free over all regions.
    """
    x = jnp.asarray(x)
    y = jnp.asarray(y)
    x, y = jnp.broadcast_arrays(x, y)
    ax = jnp.abs(x)
    s = ax + y
    # t = y - i x
    tr, ti = y, -x

    # region 1: s >= 15 —— w = 0.5641896 t/(0.5 + t^2). NOTE: region 1 is not
    # just a cheaper asymptote — it is the only form whose float32
    # intermediates survive large |z| (region 2's u(3+u) term squares to
    # overflow inside the complex divide beyond |z| ~ 4e4, which wide-cut
    # line sums reach in the far wings).
    t2r, t2i = _cmul(tr, ti, tr, ti)
    w1r, w1i = _cdiv(0.5641896 * tr, 0.5641896 * ti, 0.5 + t2r, t2i)

    # region 2: 5.5 <= s < 15 —— w = t(1.410474 + 0.5641896 u)/(0.75 + u(3 + u))
    ur, ui = t2r, t2i
    n2r = 1.410474 + 0.5641896 * ur
    n2i = 0.5641896 * ui
    n2r, n2i = _cmul(tr, ti, n2r, n2i)
    d2r, d2i = _cmul(ur, ui, 3.0 + ur, ui)
    w2r, w2i = _cdiv(n2r, n2i, 0.75 + d2r, d2i)

    # region 3: s < 5.5 and y >= 0.195|x| - 0.176 —— Hui-style [4/5] rational in t
    n3r, n3i = _cpoly(
        [0.5642236, 3.778987, 11.96482, 20.20933, 16.4955], tr, ti
    )
    d3r, d3i = _cpoly(
        [1.0, 6.699398, 21.69274, 39.27121, 38.82363, 16.4955], tr, ti
    )
    w3r, w3i = _cdiv(n3r, n3i, d3r, d3i)

    # region 4: s < 5.5 and y < 0.195|x| - 0.176 —— w = exp(u) - t*P(u)/Q(u)
    # In the active region u_r = y^2 - x^2 <= 0; clamp to avoid inf leaking
    # from inactive-region evaluation (where it is discarded anyway).
    # In the active region y < 0.195|x| - 0.176 implies u_r = y^2 - x^2 < 0,
    # so the clamp never alters active values. P and Q are Humlicek's
    # alternating-sign Horner chains, rewritten as plain polynomials in -u.
    u4r = jnp.minimum(ur, 0.0)
    u4i = ui
    p4r, p4i = _cpoly(
        [0.56419, 1.320522, 35.76683, 219.0313, 1540.787, 3321.9905, 36183.31],
        -u4r, -u4i,
    )
    q4r, q4i = _cpoly(
        [1.0, 1.841439, 61.57037, 364.2191, 2186.181, 9022.228, 24322.84, 32066.6],
        -u4r, -u4i,
    )
    frac_r, frac_i = _cdiv(p4r, p4i, q4r, q4i)
    tf_r, tf_i = _cmul(tr, ti, frac_r, frac_i)
    eu = jnp.exp(u4r)
    ex_r = eu * jnp.cos(u4i)
    ex_i = eu * jnp.sin(u4i)
    w4r = ex_r - tf_r
    w4i = ex_i - tf_i

    in_r1 = s >= 15.0
    in_r2 = (s < 15.0) & (s >= 5.5)
    in_r3 = (s < 5.5) & (y >= 0.195 * ax - 0.176)
    wr = jnp.where(in_r1, w1r, jnp.where(in_r2, w2r, jnp.where(in_r3, w3r, w4r)))
    wi = jnp.where(in_r1, w1i, jnp.where(in_r2, w2i, jnp.where(in_r3, w3i, w4i)))

    # small-y repair of the real part: Humlicek's region-IV formula computes
    # Re w as the difference exp(u) - Re(t P/Q), which cancels catastrophically
    # as y -> 0 (relative error O(1) for 2.5 < |x| < 5.5). The imaginary part
    # is stable, so a second-order Taylor expansion off the real axis is
    # accurate there:  Re w(x,y) = e^{-x^2} + y*(2x Im w - 2/sqrt(pi))
    #                              - y^2 (2x^2 - 1) e^{-x^2} + O(y^3).
    # The first-order coefficient g = 2x Im w(x,0) - 2/sqrt(pi) itself cancels
    # as x grows (both terms -> 2/sqrt(pi)); for |x| >= 5.5 use its asymptotic
    # series g = (2/sqrt(pi)) [1/(2x^2) + 3/(4x^4) + 15/(8x^6) + 105/(16x^8)]
    # instead of the difference of nearly equal numbers.
    # e^{-x^2} reused from region 4's exponential: eu = exp(min(y^2-x^2, 0)),
    # so ex2 = eu * e^{-y^2} ~ eu * (1 - y^2) to O(y^4) — avoids a second exp.
    ex2 = eu * (1.0 - y * y)
    x2 = jnp.maximum(x * x, 1.0)  # guard: series branch only used for |x| >= 5.5
    inv = 1.0 / x2
    g_series = (2.0 / _SQRT_PI) * inv * (0.5 + inv * (0.75 + inv * (1.875 + inv * 6.5625)))
    # the expansion needs Im w on the axis; wi is at (x, y) — transport it back
    # with Cauchy-Riemann (d Im/dy = d Re/dx = -2x e^{-x^2} at y=0)
    wi0 = wi + 2.0 * x * y * ex2
    g_direct = 2.0 * x * wi0 - 2.0 / _SQRT_PI
    g = jnp.where(ax >= 5.5, g_series, g_direct)
    wr_small = ex2 + y * g - y * y * (2.0 * x * x - 1.0) * ex2
    wr = jnp.where(y < _Y_SMALL, wr_small, wr)
    return wr, wi


@jax.custom_jvp
def wofz_re_im(x, y):
    """Real and imaginary parts of w(z), with an exact overflow-proof JVP.

    Differentiating the w4 rationals is a float32 trap: the quotient rule
    squares region 1's denominator (~|z|^4 -> |z|^8), which overflows for
    the far-wing arguments of narrow low-wavenumber lines (|x| = cut/alpha
    can reach 1e7) — the PRIMAL survives only because the two-division form
    never materializes d^2 (see _cdiv). Instead of linearizing the
    approximation, differentiate the true function: the Faddeeva ODE
    w'(z) = -2 z w(z) + 2i/sqrt(pi) gives the tangent from w itself with
    O(|w|) intermediates at any |z| (w -> 0 as |z| grows, so x*w stays
    bounded). Exact to the accuracy of w, stable everywhere.
    """
    return _wofz_re_im_impl(x, y)


@wofz_re_im.defjvp
def _wofz_re_im_jvp(primals, tangents):
    x, y = primals
    dx, dy = tangents
    wr, wi = wofz_re_im(x, y)
    # ODE form, from the computed w. NOT usable in the far wings: there
    # w ~ i/(sqrt(pi) z), so x*wr - y*wi cancels exactly at leading order and
    # the w4 approximation error (~1e-4) is amplified by ~|z|^2 — a measured
    # 5x-wrong far-wing Jacobian entry at |z| ~ 30.
    re_ode = -2.0 * (x * wr - y * wi)
    im_ode = -2.0 * (x * wi + y * wr) + 2.0 / _SQRT_PI
    # far wings: w'(z) = -(i/sqrt(pi)) u (1 + 3/2 u + 15/4 u^2 + 105/8 u^3),
    # u = 1/z^2 — the exact asymptotic derivative, cancellation-free, and
    # float32-safe at any |z| (|z|^2 <= 1.6e15 at |x| ~ 4e7; u underflows
    # harmlessly to 0; truncation <= 4e-5 rel at the s = 6 switch, shrinking
    # as |z|^8). The exponentially small e^{-z^2} part of w is < 2e-16 of
    # the wing magnitude at s >= 6 and is rightly dropped.
    z2r = x * x - y * y
    z2i = 2.0 * x * y
    ur, ui = _cdiv(jnp.ones_like(x), jnp.zeros_like(x), z2r, z2i)
    pr, pi = _cpoly([13.125, 3.75, 1.5, 1.0], ur, ui)
    sr, si = _cmul(ur, ui, pr, pi)
    far = (jnp.abs(x) + y) >= 6.0
    re_wp = jnp.where(far, si * (1.0 / _SQRT_PI), re_ode)
    im_wp = jnp.where(far, -sr * (1.0 / _SQRT_PI), im_ode)
    # dw = w'(z) (dx + i dy)
    dwr = re_wp * dx - im_wp * dy
    dwi = im_wp * dx + re_wp * dy
    return (wr, wi), (dwr, dwi)


def wofz_re(x, y):
    """Real part of the Faddeeva function w(x + iy), y >= 0.

    Drop-in equivalent of the reference's ``faddeyeva(x, y)`` call
    (ref line_shapes.jl:375), vectorized and branch-free. Differentiable
    (overflow-proof custom JVP; see ``wofz_re_im``).
    """
    wr, _ = wofz_re_im(x, y)
    return wr


def wofz_re_kernel(x, y):
    """Plain (no custom-JVP wrapper) real part, for Pallas kernel bodies.

    Mosaic never differentiates kernels (the line-sum kernel carries its own
    custom JVP routing tangents through the jnp oracle), and keeping the
    kernel path free of custom_jvp_call primitives avoids relying on their
    lowering inside Pallas.
    """
    wr, _ = _wofz_re_im_impl(x, y)
    return wr
