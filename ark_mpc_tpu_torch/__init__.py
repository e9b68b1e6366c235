"""ark_mpc_tpu_torch: the PyTorch/CUDA port of ark_mpc_tpu.

A second package beside the JAX reference: SPDZ-style two-party MPC over the
Curve25519 scalar field (and BN254's, with its G1 points) with batch-first
share arithmetic on torch tensors, a round-based fabric with a traced
circuit scheduler (`fabric.tracer()`), gadgets, polynomials and field matrix
products, Ed25519 point protocols and MSM, a TCP transport with TLS between
two processes (`python -m ark_mpc_tpu_torch.integration`), and hand-written
CUDA kernels (sm_90a) for the authenticated Beaver multiplication path and
the curve layer, and the dealer-free LowGear offline phase over BGV
(`LowGear`, `LowGearPrep`) beside the reference's t-generic prototype BGV
stack (`ops/ntt.py`, `offline/bgv/`, `offline/lowgear/triplets_bgv.py`).
Entry points run on the CUDA card
unless the caller passes another `device` (the tests pass "cpu").
"""

from .algebra.bn254 import G1, Fq, Fr
from .algebra.curve import CurvePoint
from .algebra.point_share import PointShare
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
from .fabric.transport import LocalTransport, TcpTransport
from .offline.base import PartyIDBeaverSource, PreprocessingPhase, TrustedDealerSource
from .offline.lowgear.core import LowGear
from .offline.structs import LowGearPrep, OfflineSizingParams

__all__ = [
    "Scalar",
    "BaseFelt",
    "ScalarShare",
    "CurvePoint",
    "Fq",
    "Fr",
    "G1",
    "PointShare",
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
    "TcpTransport",
    "PreprocessingPhase",
    "PartyIDBeaverSource",
    "TrustedDealerSource",
    "LowGear",
    "LowGearPrep",
    "OfflineSizingParams",
]

__version__ = "0.1.0"
