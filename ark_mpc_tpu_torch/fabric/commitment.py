"""Salted hash commitments over scalar batches.

Counterpart of `ark_mpc_tpu/fabric/commitment.py`: a commitment to a batch
of values is `H(value[0] || ... || value[n-1] || blinder)` with SHA3-256,
each value in its canonical big-endian 32-byte encoding, and the digest
mapped into the scalar field via `from_be_bytes_mod_order`.  The hash runs
on the host (O(n) bytes once per round).
"""

from __future__ import annotations

import hashlib

from ..algebra.scalar import Scalar


def commit_bytes(data: bytes, blinder: Scalar) -> Scalar:
    """Commitment scalar for pre-serialized value bytes and a blinder (the
    digest maps into the blinder's field, on the blinder's device)."""
    digest = hashlib.sha3_256(data + blinder.to_bytes_be()).digest()
    return type(blinder).from_be_bytes_mod_order(digest, device=blinder.device)


def verify_bytes(data: bytes, blinder: Scalar, commitment: Scalar) -> bool:
    expected = commit_bytes(data, blinder)
    return bool(expected.equals(commitment).all())


def commit(values: Scalar, blinder: Scalar) -> Scalar:
    """Commitment scalar for a batch of values and a blinder."""
    return commit_bytes(values.to_bytes_be(), blinder)


def verify(values: Scalar, blinder: Scalar, commitment: Scalar) -> bool:
    """Check that `commitment` opens to (values, blinder)."""
    return verify_bytes(values.to_bytes_be(), blinder, commitment)
