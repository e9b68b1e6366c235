"""MPC gadgets over shared values (counterpart of `ark_mpc_tpu/gadgets`)."""

from .bits import bit_xor, bit_xor_public
from .products import prefix_product

__all__ = ["bit_xor", "bit_xor_public", "prefix_product"]
