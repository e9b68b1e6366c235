"""LowGear offline phase (`offline-phase/src/lowgear/`): the dealer-free
triple generation over BGV-over-l and the two-party protocols downstream of
it, and the t-generic prototype over the BGV test plaintext field
(`setup.run_key_exchange`, `triplets_bgv.py`).  Counterpart of
`ark_mpc_tpu/offline/lowgear/`."""

from .core import LowGear, resolve_bgv_ring
from .protocols import (
    beaver_mul,
    generate_inverse_tuples,
    generate_shared_bits,
    open_and_check_macs,
    public_coin_scalars,
)

__all__ = [
    "LowGear",
    "resolve_bgv_ring",
    "beaver_mul",
    "generate_inverse_tuples",
    "generate_shared_bits",
    "open_and_check_macs",
    "public_coin_scalars",
]
