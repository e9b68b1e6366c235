"""Field instances for the Curve25519 instantiation.

  - SCALAR_FIELD: the group order l = 2^252 + 27742...493 (the SPDZ share
    field; every share/MAC lives here).
  - BASE_FIELD: p = 2^255 - 19, the Edwards curve coordinate field.
"""

from .limbs import FieldSpec

CURVE25519_ORDER = 2**252 + 27742317777372353535851937790883648493
ED25519_PRIME = 2**255 - 19

SCALAR_FIELD = FieldSpec(CURVE25519_ORDER, "curve25519-scalar")
BASE_FIELD = FieldSpec(ED25519_PRIME, "ed25519-base")
