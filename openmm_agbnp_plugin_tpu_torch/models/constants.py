"""Physical and model constants of the AGBNP/GaussVol implicit-solvent model.

Values mirror the reference plugin's compile-time defines
(reference: gaussvol/gaussvol.h:42-63, openmmapi/include/AGBNPForce.h:13-33,
openmmapi/include/AGBNPUtils.h:122-126) but are kept in float64 here; the
reference declares several of them as float literals, the difference is ~1e-8
relative and far below the 1e-5 parity target.

Units: nm, kJ/mol (same as the reference).
"""

import math

# conversion factors from spheres to Gaussians (gaussvol.h:46-47)
KFC = 2.2269859253
PFC = 2.5

PI = math.pi

# minimum switched volume for an overlap to enter the tree (gaussvol.h:52)
MIN_GVOL = 1.1754943508222875e-38  # FLT_MIN

# maximum overlap order (tree depth in atoms) (gaussvol.h:55)
MAX_ORDER = 8

ANG = 0.1
ANG3 = 0.001

# overlap-volume switching function window, nm^3 (gaussvol.h:62-63)
VOLMINA = 0.01 * ANG3
VOLMINB = 0.1 * ANG3

# radius offset used to build the "large" radii for the surface-area
# finite difference (AGBNPForce.h:25-27)
AGBNP_RADIUS_INCREMENT = 0.5 * ANG
AGBNP2_RADIUS_INCREMENT = 0.1 * ANG

# solvent probe radius for AGBNP2 (AGBNPForce.h:30)
SOLVENT_RADIUS = 1.0 * ANG

# offset added to the Born radius in the vdW dispersion term (AGBNPForce.h:33)
AGBNP_HB_RADIUS = 1.4 * ANG

# I4 lookup-table horizon: Q4ij == 0 beyond this distance, nm
# (AGBNPUtils.h:122-126)
AGBNP_I4LOOKUP_MAXA = 2.0
AGBNP_I4LOOKUP_NA = 16

# radius quantization used to build unique radius types (AGBNPUtils.h:155)
AGBNP_RADIUS_PRECISION = 10000

# GB dielectric model (ReferenceAGBNPKernels.cpp:465-468)
DIELECTRIC_IN = 1.0
DIELECTRIC_OUT = 80.0
TOKJMOL = 4.184 * 332.0 / 10.0  # the /10 converts 1/r from nm to Angstrom
DIELECTRIC_FACTOR = TOKJMOL * (-0.5) * (1.0 / DIELECTRIC_IN - 1.0 / DIELECTRIC_OUT)

FOUR_PI = 4.0 * PI
PIFAC = 1.0 / FOUR_PI


def sphere_volume(radius):
    """Volume of a sphere, (4/3) pi r^3."""
    return (4.0 / 3.0) * PI * radius * radius * radius
