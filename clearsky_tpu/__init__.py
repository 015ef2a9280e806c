"""clearsky_tpu — a line-by-line clear-sky radiative transfer framework in JAX.

A from-scratch JAX/XLA/Pallas re-design with the full capability surface of the
reference clear-sky framework (ClearSky.jl): HITRAN line-catalog and CIA
ingestion, TIPS-scaled Voigt/Lorentz/Doppler/sub-Lorentzian opacities, baked
Chebyshev opacity tables or direct line-by-line evaluation, a discretized
Schwarzschild flux core with hemispheric stream quadrature, adiabats and
hydrostatics, a radiative-convective model, orbital mechanics and insolation —
all built array-first for an accelerator (an NVIDIA GPU; the CPU runs the
plain paths), with wavenumber-mesh sharding for multi-device scale (see
``clearsky_tpu.parallel``).
"""

from . import constants
from .constants import (
    C_LIGHT,
    H_PLANCK,
    K_BOLTZ,
    SIGMA_SB,
    R_GAS,
    P_ATM,
    N_AVOGADRO,
    DALTON,
    G_GRAV,
    LOSCHMIDT_SQ,
    T_REF_HITRAN,
    T_ICE,
    P_MIN,
)
from .utils.grids import (
    chebygrid,
    pressuregrid,
    logrange,
    meshgrid,
    trapz,
    deriv,
)
from .utils.rootfind import regula_falsi, secant
from .ops.planck import (
    nu2f,
    f2nu,
    nu2lam,
    lam2nu,
    lam2f,
    f2lam,
    planck,
    normplanck,
    dplanck,
    stefanboltzmann,
    equilibrium_temperature,
    dtau_dP,
)
from .ops.faddeeva import wofz_re
from .ops.lineshape import (
    scale_intensity,
    alpha_doppler,
    gamma_lorentz,
    fdoppler,
    florentz,
    fvoigt,
    chi_phco2,
)
from .ops.linesum import build_line_window_plan, sigma_from_lines
from .spectra.par import read_par
from .spectra.synthetic import synthetic_lines
from .spectra.lines import SpectralLines
from .spectra.molparam import molparam
from .absorption.domain import AtmosphericDomain
from .absorption.gas import (
    Gas,
    DirectGas,
    GrayGas,
    SemiGrayGas,
    MultiGas,
    WellMixedGas,
    VariableGas,
    opacity_error,
)
from .absorption.cia import read_cia, CIATables, CIA, cia_xsec
from .absorption.absorbers import (
    AbsorberStack,
    AcceleratedAbsorber,
    unify_absorbers,
)
from .atmosphere.profile import AtmosphericProfile
from .atmosphere.hydrostatics import scale_height, hydrostatic, altitude, Hydrostatic
from .atmosphere.adiabats import (
    lapse_rate_dry,
    lapse_rate_moist,
    lapse,
    DryAdiabat,
    MoistAdiabat,
    tropopause,
    pressure_of_temperature,
)
from .atmosphere.saturation import (
    psat_h2o,
    tsat_co2,
    ozonelayer,
    condensible_profile,
    haircut,
    rayleigh_co2,
)
from .rt.discretized import FluxPack
from .rt.fluxes import (
    Discretized,
    Radau,
    RadauEq,
    optical_depth,
    transmittance,
    outgoing,
    monochromatic_fluxes,
    fluxes,
    net_fluxes,
    radiate,
    top_fluxes,
    top_imbalance,
    bottom_fluxes,
)

from .models.sweep import batched_heating, run_sweep, shard_sweep
from .models.rcm import (
    RCM,
    heating,
    radiate_state,
    step,
    step_n,
    run,
    jacobian,
    update_absorber,
    convective_adjustment,
)
from .orbital import (
    periapsis,
    apoapsis,
    semimajoraxis,
    eccentricity,
    meananomaly,
    trueanomaly,
    eccentricanomaly,
    orbitalperiod,
    orbitaldistance,
    orbit,
    substellarlatitude,
    hourangle,
    diurnalfluxfactor,
    diurnalfluxfactors,
    annualfluxfactor,
    annualfluxfactors,
)
from . import parallel

__version__ = "0.1.0"
