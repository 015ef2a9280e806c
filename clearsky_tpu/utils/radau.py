"""Batched adaptive Radau IIA(5) for per-lane scalar ODEs, on device.

The reference's second flux engine integrates a scalar ODE per wavenumber with
an adaptive 5th-order Radau IIA method (ScalarRadau, used at ClearSky.jl
``src/core/radau.jl:90,130,177`` and ``src/atmospherics.jl:87,161,441``). The
Array-first inversion: instead of one adaptive integration per wavenumber on
its own thread, ALL lanes (wavenumber x stream) march together inside one
``lax.while_loop``, each lane carrying its own position, step size, and error
controller — dense masked arithmetic instead of divergent control flow, so
the whole adaptive solve jit-compiles to a single device program.

Method (Hairer & Wanner, "Solving ODEs II", Sec. IV.8 — the same published
construction scipy's ``Radau`` implements): 3-stage Radau IIA collocation,
simplified Newton on the stage system solved in the eigenbasis of the Butcher
matrix (one real + one complex-conjugate eigenvalue; for scalar lanes the
"LU solves" collapse to scalar divisions, the complex one written in real
arithmetic, no complex dtype), the 3rd-order embedded error
estimate with the stiffness-damped rejection refinement, and the predictive
two-step (Gustafsson) step-size controller.

This module is generic; the flux cores build on it in ``rt.radau``, and it
also backs adaptive hydrostatic/adiabat integration checks. It is a forward
engine (the production RT path remains the discretized core; SURVEY.md §7.0).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["radau_scalar", "radau_dense", "RadauResult"]

_S6 = np.sqrt(6.0)
# collocation nodes and embedded-error weights (Hairer & Wanner IV.8)
_C = np.array([(4.0 - _S6) / 10.0, (4.0 + _S6) / 10.0, 1.0])
_E = np.array([-13.0 - 7.0 * _S6, -13.0 + 7.0 * _S6, -1.0]) / 3.0
# eigenvalues of inv(A): one real, one complex pair
_MU_REAL = 3.0 + 3.0 ** (2.0 / 3.0) - 3.0 ** (1.0 / 3.0)
_MU_C_RE = 3.0 + 0.5 * (3.0 ** (1.0 / 3.0) - 3.0 ** (2.0 / 3.0))
_MU_C_IM = 0.5 * (3.0 ** (5.0 / 6.0) + 3.0 ** (7.0 / 6.0))
# stage <-> eigenbasis transformations (Z = T W, W = TI Z)
_T = np.array([
    [0.09443876248897524, -0.14125529502095421, 0.03002919410514742],
    [0.25021312296533332, 0.20412935229379994, -0.38294211275726192],
    [1.0, 1.0, 0.0],
])
_TI = np.array([
    [4.17871859155190428, 0.32768282076106237, 0.52337644549944951],
    [-4.17871859155190428, -0.32768282076106237, 0.47662355450055044],
    [0.50287263494578682, -2.57192694985560522, 0.59603920482822492],
])

_MIN_FACTOR = 0.2
_MAX_FACTOR = 10.0


class RadauResult(NamedTuple):
    """y: final state per lane; steps: accepted steps; ok: reached x1 within
    ``max_steps`` (per lane)."""

    y: jnp.ndarray
    steps: jnp.ndarray
    ok: jnp.ndarray


class _State(NamedTuple):
    x: jnp.ndarray
    y: jnp.ndarray
    f0: jnp.ndarray
    h: jnp.ndarray         # current step size (positive)
    done: jnp.ndarray
    h_old: jnp.ndarray     # last accepted step (predictive controller)
    err_old: jnp.ndarray   # its error norm (<=0: no history yet)
    rej: jnp.ndarray       # previous attempt of the current step was rejected
    steps: jnp.ndarray
    it: jnp.ndarray


def _rms3(a, b, c):
    return jnp.sqrt((a * a + b * b + c * c) / 3.0)


def _initial_step(f, x0, y0, f0, d, span, scale, args):
    """Per-lane starting step (the standard curvature heuristic; order-3
    error control => exponent 1/4)."""
    d0 = jnp.abs(y0) / scale
    d1 = jnp.abs(f0) / scale
    h0 = jnp.where((d0 < 1e-5) | (d1 < 1e-5), 1e-6, 0.01 * d0 / jnp.maximum(d1, 1e-300))
    h0 = jnp.minimum(h0, span)
    f1 = f(x0 + d * h0, y0 + d * h0 * f0, args)
    d2 = jnp.abs(f1 - f0) / scale / jnp.maximum(h0, 1e-300)
    dm = jnp.maximum(d1, d2)
    h1 = jnp.where(dm <= 1e-15, jnp.maximum(1e-6, h0 * 1e-3),
                   (0.01 / jnp.maximum(dm, 1e-300)) ** 0.25)
    return jnp.minimum(jnp.minimum(100.0 * h0, h1), span)


@partial(jax.jit, static_argnames=("f", "newton_iters", "max_steps"))
def radau_scalar(
    f,
    y0,
    x0,
    x1,
    args=None,
    rtol: float = 1e-5,
    atol: float = 1e-9,
    newton_iters: int = 6,
    max_steps: int = 10_000,
) -> RadauResult:
    """Integrate dy/dx = f(x, y, args) from x0 to x1, one scalar ODE per lane.

    Arguments:
      f: vectorized RHS — f(x, y, args) with x, y of shape [lanes] -> [lanes].
        Must be jax-traceable; the Jacobian df/dy is taken by ``jax.jvp``.
      y0: initial state [lanes].
      x0, x1: integration bounds, scalars or [lanes]; the direction
        sign(x1 - x0) must be uniform across lanes (per-lane spans may differ;
        finished lanes idle while the stiffest lane completes).
      newton_iters: simplified-Newton iterations per attempted step, >= 2
        (an RHS linear in y converges on the 2nd iteration — the
        Schwarzschild case; nonlinear problems want the default 6).

    Equivalent role to the reference's ``ScalarRadau.radau`` calls
    (ref core/radau.jl:90,130,177) — but batched over every lane at once.
    """
    if newton_iters < 2:
        raise ValueError("newton_iters must be >= 2 (convergence is rate-tested)")
    y0 = jnp.atleast_1d(jnp.asarray(y0))
    dtype = jnp.result_type(y0.dtype, jnp.float32)
    y0 = y0.astype(dtype)
    L = y0.shape[0]
    x0 = jnp.broadcast_to(jnp.asarray(x0, dtype), (L,))
    x1 = jnp.broadcast_to(jnp.asarray(x1, dtype), (L,))
    span = jnp.abs(x1 - x0)
    # uniform direction across lanes (sign of the widest lane's span)
    d = jnp.where(jnp.sum(x1 - x0) < 0, -1.0, 1.0).astype(dtype)

    eps = float(jnp.finfo(dtype).eps)
    # rtol/atol are traced under jit (no recompile per tolerance)
    rtol = jnp.asarray(rtol, dtype)
    atol = jnp.asarray(atol, dtype)
    newton_tol = jnp.maximum(10.0 * eps / rtol, jnp.minimum(0.03, jnp.sqrt(rtol)))

    MU_R = jnp.asarray(_MU_REAL, dtype)
    MU_CR = jnp.asarray(_MU_C_RE, dtype)
    MU_CI = jnp.asarray(_MU_C_IM, dtype)
    Tm = jnp.asarray(_T, dtype)
    TIm = jnp.asarray(_TI, dtype)
    E = jnp.asarray(_E, dtype)
    C = jnp.asarray(_C, dtype)

    def jac(x, y):
        _, Jv = jax.jvp(lambda yy: f(x, yy, args), (y,), (jnp.ones_like(y),))
        return Jv

    f0 = f(x0, y0, args).astype(dtype)
    # NaN lanes (a poisoned radau_dense segment, or a NaN RHS at x0) can
    # never accept a step — mark them done up front so one bad lane doesn't
    # pin the whole batch's while_loop at max_steps. A NaN RHS must ALSO
    # poison y: done lanes read as ok, and an untouched finite y0 would
    # otherwise be passed off as the converged integral.
    y0 = jnp.where(jnp.isnan(f0), jnp.nan, y0)
    scale0 = atol + jnp.abs(y0) * rtol
    h_init = _initial_step(f, x0, y0, f0, d, jnp.maximum(span, 1e-30), scale0, args)

    st = _State(
        x=x0, y=y0, f0=f0, h=h_init,
        done=(span <= 0) | jnp.isnan(y0),
        h_old=jnp.zeros((L,), dtype), err_old=jnp.full((L,), -1.0, dtype),
        rej=jnp.zeros((L,), bool),
        steps=jnp.zeros((L,), jnp.int32), it=jnp.asarray(0, jnp.int32),
    )

    def cond(s):
        return jnp.any(~s.done) & (s.it < max_steps)

    def body(s):
        active = ~s.done
        rem = jnp.abs(x1 - s.x)
        h_abs = jnp.minimum(s.h, rem)
        h_abs = jnp.maximum(h_abs, 16.0 * eps * jnp.maximum(jnp.abs(s.x), 1.0))
        hs = d * h_abs  # signed step, as in the published algorithm
        J = jac(s.x, s.y)

        mr = MU_R / hs
        mcr = MU_CR / hs
        mci = MU_CI / hs
        den_r = mr - J                       # real eigen-divisor
        dcr = mcr - J                        # complex eigen-divisor (real part)
        inv_c = 1.0 / (dcr * dcr + mci * mci)

        scale = atol + jnp.abs(s.y) * rtol

        # simplified Newton on the 3 stage increments, in the eigenbasis
        def newton(k, carry):
            W0, W1, W2, dwn, rate, live, nit = carry
            Z0 = Tm[0, 0] * W0 + Tm[0, 1] * W1 + Tm[0, 2] * W2
            Z1 = Tm[1, 0] * W0 + Tm[1, 1] * W1 + Tm[1, 2] * W2
            Z2 = Tm[2, 0] * W0 + Tm[2, 1] * W1 + Tm[2, 2] * W2
            F0 = f(s.x + C[0] * hs, s.y + Z0, args)
            F1 = f(s.x + C[1] * hs, s.y + Z1, args)
            F2 = f(s.x + C[2] * hs, s.y + Z2, args)
            # complex pair: TI inv(A) T has the 2x2 block [[mr_c, +mi_c],
            # [-mi_c, mr_c]] (eigenvalue mr_c - i*mi_c), so the off-diagonal
            # signs below are load-bearing
            g_r = (TIm[0, 0] * F0 + TIm[0, 1] * F1 + TIm[0, 2] * F2) - mr * W0
            g_cr = (TIm[1, 0] * F0 + TIm[1, 1] * F1 + TIm[1, 2] * F2) - (
                mcr * W1 + mci * W2
            )
            g_ci = (TIm[2, 0] * F0 + TIm[2, 1] * F1 + TIm[2, 2] * F2) - (
                mcr * W2 - mci * W1
            )
            dW0 = g_r / den_r
            dW1 = (g_cr * dcr - g_ci * mci) * inv_c
            dW2 = (g_ci * dcr + g_cr * mci) * inv_c
            dwn_new = _rms3(dW0 / scale, dW1 / scale, dW2 / scale)
            rate_new = jnp.where(
                dwn > 0, dwn_new / jnp.maximum(dwn, 1e-300), rate
            )
            W0 = jnp.where(live, W0 + dW0, W0)
            W1 = jnp.where(live, W1 + dW1, W1)
            W2 = jnp.where(live, W2 + dW2, W2)
            settled = (dwn_new == 0.0) | (
                (rate_new >= 0)
                & (rate_new < 1.0)
                & (rate_new / (1.0 - rate_new) * dwn_new < newton_tol)
            )
            dwn = jnp.where(live, dwn_new, dwn)
            rate = jnp.where(live, rate_new, rate)
            nit = nit + live.astype(dtype)
            live = live & ~settled
            return (W0, W1, W2, dwn, rate, live, nit)

        zeros = jnp.zeros((L,), dtype)
        W0, W1, W2, dwn, rate, live, nit = lax.fori_loop(
            0, newton_iters, newton,
            (zeros, zeros, zeros, zeros, jnp.full((L,), -1.0, dtype),
             jnp.ones((L,), bool), zeros),
        )
        conv = (dwn == 0.0) | (
            (rate >= 0)
            & (rate < 1.0)
            & (rate / jnp.maximum(1.0 - rate, 1e-6) * dwn < newton_tol)
        )

        Z2 = Tm[2, 0] * W0 + Tm[2, 1] * W1 + Tm[2, 2] * W2
        y_new = s.y + Z2
        ZE = (
            (Tm[0, 0] * W0 + Tm[0, 1] * W1 + Tm[0, 2] * W2) * E[0]
            + (Tm[1, 0] * W0 + Tm[1, 1] * W1 + Tm[1, 2] * W2) * E[1]
            + Z2 * E[2]
        ) / hs
        scale_e = atol + jnp.maximum(jnp.abs(s.y), jnp.abs(y_new)) * rtol
        e_raw = (s.f0 + ZE) / den_r
        err = jnp.abs(e_raw) / scale_e
        # stiffness-damped re-estimate, per the published construction (Hairer
        # RADAU5 / scipy Radau): applied only on a RETRY of a rejected step
        # ('if rejected and error_norm > 1') — using it on the first attempt
        # would accept steps the reference error control rejects
        f_damp = f(s.x, s.y + e_raw, args)
        err2 = jnp.abs((f_damp + ZE) / den_r) / scale_e
        err = jnp.where(s.rej & (err > 1.0), err2, err)

        safety = 0.9 * (2.0 * newton_iters + 1.0) / (2.0 * newton_iters + nit)
        # predictive (two-step) controller where history exists
        mult = jnp.where(
            (s.err_old > 0) & (s.h_old > 0) & (err > 0),
            (h_abs / jnp.maximum(s.h_old, 1e-300))
            * (s.err_old / jnp.maximum(err, 1e-300)) ** 0.25,
            1.0,
        )
        factor = jnp.minimum(1.0, mult) * jnp.maximum(err, 1e-12) ** -0.25
        accept = conv & (err <= 1.0) & active

        x_next = s.x + hs
        reached = jnp.abs(x1 - x_next) <= 16.0 * eps * jnp.maximum(jnp.abs(x1), 1.0)
        f_next = f(x_next, y_new, args)

        h_acc = h_abs * jnp.clip(safety * factor, _MIN_FACTOR, _MAX_FACTOR)
        h_rej = jnp.where(conv, h_abs * jnp.maximum(_MIN_FACTOR, safety * factor),
                          0.5 * h_abs)

        return _State(
            x=jnp.where(accept, x_next, s.x),
            y=jnp.where(accept, y_new, s.y),
            f0=jnp.where(accept, f_next, s.f0),
            h=jnp.where(active, jnp.where(accept, h_acc, h_rej), s.h),
            done=s.done | (accept & reached),
            h_old=jnp.where(accept, h_abs, s.h_old),
            err_old=jnp.where(accept, err, s.err_old),
            rej=jnp.where(active, ~accept, s.rej),
            steps=s.steps + accept.astype(jnp.int32),
            it=s.it + 1,
        )

    out = lax.while_loop(cond, body, st)
    return RadauResult(y=out.y, steps=out.steps, ok=out.done)


def radau_dense(
    f,
    y0,
    xs,
    args=None,
    rtol: float = 1e-5,
    atol: float = 1e-9,
    newton_iters: int = 6,
    max_steps: int = 10_000,
):
    """Adaptive integration with output at every node of ``xs`` [nx].

    Equivalent role to the reference's dense-output ``radau!``
    (ref core/radau.jl:109, atmospherics.jl:161,441): integrates each segment
    [xs[k], xs[k+1]] adaptively (a ``lax.scan`` of :func:`radau_scalar`
    segments) and returns y at the nodes, shape [nx, lanes]. ``xs`` must be
    monotone; it is shared across lanes.
    """
    y0 = jnp.atleast_1d(jnp.asarray(y0))
    xs = jnp.asarray(xs, jnp.result_type(y0.dtype, jnp.float32))

    def seg(y, x01):
        xa, xb = x01
        r = radau_scalar(
            f, y, xa, xb, args=args, rtol=rtol, atol=atol,
            newton_iters=newton_iters, max_steps=max_steps,
        )
        # a lane that exhausted max_steps mid-segment must not pass off its
        # partial integral as converged — poison it (NaN propagates through
        # the remaining segments and is caught by any downstream check)
        y_next = jnp.where(r.ok, r.y, jnp.nan)
        return y_next, y_next

    _, ys = lax.scan(seg, y0, (xs[:-1], xs[1:]))
    return jnp.concatenate([y0[None].astype(ys.dtype), ys], axis=0)
