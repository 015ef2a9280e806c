"""Grid construction and basic numeric utilities.

Array-first equivalents of the reference's grid helpers (ClearSky.jl
``src/util.jl:18-93``). Node placement happens host-side in numpy (it is
setup-time work); integration/differentiation helpers are jnp and jit-safe.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

__all__ = [
    "chebygrid",
    "pressuregrid",
    "logrange",
    "meshgrid",
    "trapz",
    "deriv",
    "p2omega",
    "omega2p",
    "domega_fac",
    "p2iota",
    "iota2p",
    "diota_fac",
]


def chebygrid(a: float, b: float, n: int) -> np.ndarray:
    """Chebyshev-extreme (Gauss-Lobatto) points on [a, b], ascending.

    Matches the node placement used by the reference's interpolation grids
    (BasicInterpolators ``chebygrid``, used at ref gases.jl:57-58, util.jl:22).
    """
    if n < 2:
        raise ValueError("chebygrid needs n >= 2")
    k = np.arange(n)
    x = -np.cos(np.pi * k / (n - 1))  # ascending in [-1, 1]
    return a + (b - a) * (x + 1.0) / 2.0


def pressuregrid(p_top: float, p_surf: float, n: int) -> np.ndarray:
    """Chebyshev-spaced log-pressure grid from top to surface, ascending [Pa].

    Ref util.jl:19-23.
    """
    if not p_surf > p_top:
        raise ValueError("p_surf must exceed p_top")
    if n < 3:
        raise ValueError("need n >= 3")
    return np.exp(chebygrid(np.log(p_top), np.log(p_surf), n))


def logrange(a: float, b: float, n: int = 101, gamma: float = 1.0) -> np.ndarray:
    """Stretched range with logarithmic clustering toward ``a``. Ref util.jl:43-45."""
    return ((10.0 ** np.linspace(0.0, gamma, n)) - 1.0) * (b - a) / (10.0**gamma - 1.0) + a


def meshgrid(x, y):
    """Matrix-style meshgrid matching ref util.jl:36-40: X,Y of shape [len(y), len(x)]."""
    X = jnp.ones((jnp.shape(y)[0], 1)) * jnp.reshape(x, (1, -1))
    Y = jnp.reshape(y, (-1, 1)) * jnp.ones((1, jnp.shape(x)[0]))
    return X, Y


def trapz(x, y, axis: int = -1):
    """Trapezoid-rule integral of y(x). Ref util.jl:26-33.

    jit-safe; supports batched ``y`` along ``axis``.
    """
    return jnp.trapezoid(y, x, axis=axis)


def _quaddiff_deriv(x, x1, x2, x3, y1, y2, y3):
    """First derivative at x of the parabola through three points. Ref util.jl:48-59."""
    z1 = x1**2 - x2**2
    z2 = x2**2 - x3**2
    w = z1 / z2
    b = (y1 - y2 - (y2 - y3) * w) / (x1 - x2 - (x2 - x3) * w)
    a = (y2 - y3 - b * (x2 - x3)) / z2
    return 2.0 * a * x + b


def deriv(x, y):
    """3-point parabolic derivative estimate of y(x) on a (possibly nonuniform) grid.

    Ref util.jl:66-93 (the ``T`` argument there is unused by the live code path).
    """
    x = jnp.asarray(x)
    y = jnp.asarray(y)
    d_first = (y[1] - y[0]) / (x[1] - x[0])
    d_last = (y[-1] - y[-2]) / (x[-1] - x[-2])
    d_mid = _quaddiff_deriv(x[1:-1], x[:-2], x[1:-1], x[2:], y[:-2], y[1:-1], y[2:])
    return jnp.concatenate([d_first[None], d_mid, d_last[None]])


# -----------------------------------------------------------------------------
# transformed pressure coordinates (ref util.jl:4-14): the sqrt(P) coordinates
# concentrate resolution in the upper atmosphere for column integrations.

def p2omega(P):
    """Upward coordinate omega = -sqrt(P). Ref util.jl:5."""
    return -jnp.sqrt(P)


def omega2p(omega):
    """Inverse of p2omega. Ref util.jl:6."""
    return omega * omega


def domega_fac(P):
    """Jacobian factor dP/domega magnitude = 2 sqrt(P). Ref util.jl:7."""
    return 2.0 * jnp.sqrt(P)


def p2iota(P):
    """Downward coordinate iota = +sqrt(P). Ref util.jl:11."""
    return jnp.sqrt(P)


def iota2p(iota):
    """Inverse of p2iota. Ref util.jl:12."""
    return iota * iota


def diota_fac(P):
    """Jacobian factor for iota coordinate. Ref util.jl:13."""
    return 2.0 * jnp.sqrt(P)
