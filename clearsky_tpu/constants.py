"""Physical constants.

Array-first re-implementation of the constants in the reference framework
(ClearSky.jl, ``src/constants.jl:1-27``). Values are identical CODATA numbers;
names are ASCII equivalents of the reference's Unicode symbols.
"""

# speed of light [m/s]  (ref constants.jl:2, 𝐜)
C_LIGHT = 299792458.0
# Planck constant [J*s]  (ref constants.jl:4, 𝐡)
H_PLANCK = 6.62607015e-34
# Boltzmann constant [J/K]  (ref constants.jl:6, 𝐤)
K_BOLTZ = 1.38064852e-23
# Stefan-Boltzmann constant [W/m^2/K^4]  (ref constants.jl:8, 𝛔)
SIGMA_SB = 5.67037442e-8
# universal gas constant [J/K/mole]  (ref constants.jl:10, 𝐑)
R_GAS = 8.31446262
# Pascals in 1 atm  (ref constants.jl:12, 𝐀)
P_ATM = 101325.0
# Avogadro's number [molecules/mole]  (ref constants.jl:14, 𝐍𝐚)
N_AVOGADRO = 6.02214076e23
# Dalton [kg]  (ref constants.jl:16, 𝐃𝐚)
DALTON = 1.66053907e-27
# gravitational constant [m^3/kg/s^2]  (ref constants.jl:18, 𝐆)
G_GRAV = 6.6743e-11
# Loschmidt number squared [molecules^2/cm^6]  (ref constants.jl:20, 𝐋𝐨²)
LOSCHMIDT_SQ = 7.21879268e38
# Loschmidt number [molecules/cm^3 at 1 amagat] — kept separately because
# LOSCHMIDT_SQ (7.2e38) exceeds float32 max (3.4e38): f32 compute paths (the
# GPU) must multiply by LOSCHMIDT twice instead of by the squared constant
# once (see absorption.cia.cia_xsec)
LOSCHMIDT = 2.686781e19

# HITRAN reference temperature [K]  (ref constants.jl:23, 𝐓ᵣ)
T_REF_HITRAN = 296.0
# 0 degrees Celsius [K]  (ref constants.jl:25, 𝐓₀)
T_ICE = 273.15
# minimum pressure for temperature/pressure profiles [Pa]  (ref constants.jl:27, 𝐏ₘᵢₙ)
P_MIN = 1e-9

# second radiation constant c2 = 100*h*c/k [cm K]  (ref line_shapes.jl:5, 𝐜₂)
C2_RADIATION = 100.0 * H_PLANCK * C_LIGHT / K_BOLTZ

# TIPS partition-function fit temperature validity range [K]
# (ref molparam.jl:1-2, TMIN/TMAX)
TIPS_TMIN = 25.0
TIPS_TMAX = 1000.0
