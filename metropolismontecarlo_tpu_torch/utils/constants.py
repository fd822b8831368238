"""Physical constants and unit conventions (counterpart of
metropolismontecarlo_tpu/utils/constants.py).

Distances in Angstrom, energies in Kelvin (E/kB), charges in elementary
charges.  COULOMB_FACTOR = e^2/(4 pi eps0 kB) in K*Angstrom, so that
q_i q_j * COULOMB_FACTOR / r_ij is an energy in Kelvin.  CODATA-2018
values.
"""

import math

ELEMENTARY_CHARGE = 1.602176634e-19  # C
BOLTZMANN = 1.380649e-23  # J/K
AVOGADRO = 6.02214076e23  # 1/mol
EPS0 = 8.8541878128e-12  # F/m

_E2_OVER_4PIEPS0_JM = ELEMENTARY_CHARGE**2 / (4.0 * math.pi * EPS0)
# ~1.671009e5 K*Angstrom
COULOMB_FACTOR = _E2_OVER_4PIEPS0_JM * 1.0e10 / BOLTZMANN

KJ_PER_MOL_TO_K = 1000.0 / (AVOGADRO * BOLTZMANN)  # ~120.272
NM_TO_ANGSTROM = 10.0
