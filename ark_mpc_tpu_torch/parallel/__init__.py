"""Fused protocol steps (single-device half; the sharded forms come later)."""

from .step import beaver_mul_step, flagship_forward, mac_check_fold

__all__ = ["beaver_mul_step", "flagship_forward", "mac_check_fold"]
