"""ark_mpc_tpu_torch: the PyTorch/CUDA port of ark_mpc_tpu.

A second package beside the JAX reference: SPDZ-style two-party MPC over the
Curve25519 scalar field with batch-first share arithmetic on torch tensors,
a round-based fabric, and hand-written CUDA kernels (sm_90a) for the
authenticated Beaver multiplication path.  Entry points run on the CUDA card
unless the caller passes another `device` (the tests pass "cpu").
"""

from .algebra.scalar import BaseFelt, Scalar
from .algebra.share import PARTY0, PARTY1, ScalarShare
from .fabric.context import MpcFabric
from .fabric.errors import (
    AuthenticationError,
    MpcError,
    NetworkError,
    SetupError,
)
from .fabric.simulator import execute_mock_mpc, execute_mock_mpc_dealer
from .fabric.transport import LocalTransport
from .offline.base import PartyIDBeaverSource, PreprocessingPhase, TrustedDealerSource

__all__ = [
    "Scalar",
    "BaseFelt",
    "ScalarShare",
    "PARTY0",
    "PARTY1",
    "MpcFabric",
    "MpcError",
    "AuthenticationError",
    "NetworkError",
    "SetupError",
    "execute_mock_mpc",
    "execute_mock_mpc_dealer",
    "LocalTransport",
    "PreprocessingPhase",
    "PartyIDBeaverSource",
    "TrustedDealerSource",
]

__version__ = "0.1.0"
