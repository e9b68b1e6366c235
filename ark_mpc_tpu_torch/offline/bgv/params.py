"""BGV parameter sets of the t-generic prototype.

Counterpart of `ark_mpc_tpu/offline/bgv/params.py` (the reference's
`BGVParams`, `mp-spdz-rs/src/fhe/params.rs:41-95`): ring dimension N (a
power of two, negacyclic ring X^N + 1), an NTT-friendly plaintext prime
t = 1 (mod 2N), the ciphertext RNS basis, noise parameters and
(de)serialization.  The primes, the CRT constants and the serialized form
equal the reference's.  The NTT plans live on `device` (the CUDA card
unless given); `q_ntt`, one plan of the L ciphertext primes, stands for the
reference's L plans (`q_plans`), so that one transform covers a whole
(..., L, N) RNS polynomial.
"""

from __future__ import annotations

import math

import torch

from ...device import resolve_device
from ...ops.modular32 import PrimeSpec, find_primes
from ...ops.ntt import NttPlan

DEFAULT_DROWN_SEC = 64  # statistical drowning security (the test parameter
#                          sets keep the RNS basis small; the production
#                          pipeline over l drowns at 128, `bgv_l.py`)


class BgvParams:
    """One BGV parameter set (hashable)."""

    def __init__(self, n: int, plaintext_modulus: int, q_bits: int = 30,
                 n_q_primes: int = 6, drown_sec: int = DEFAULT_DROWN_SEC,
                 cbd_k: int = 10, device=None):
        if n & (n - 1) or n < 1:
            raise ValueError(f"N must be a power of two, got {n}")
        if (plaintext_modulus - 1) % (2 * n):
            raise ValueError("plaintext modulus must be 1 mod 2N for slot packing")
        self.device = resolve_device(device)
        self.n = n
        self.t = plaintext_modulus
        self.t_spec = PrimeSpec(plaintext_modulus)
        self.t_plan = NttPlan(plaintext_modulus, n, negacyclic=True, device=self.device)
        self.drown_sec = drown_sec
        self.cbd_k = cbd_k  # centered binomial parameter (sigma = sqrt(k/2))

        self.q_primes = find_primes(n_q_primes, order=2 * n, bits=q_bits)
        self.q_specs = tuple(PrimeSpec(q) for q in self.q_primes)
        self.q_ntt = NttPlan(self.q_primes, n, negacyclic=True, device=self.device)
        self.q = math.prod(self.q_primes)
        # CRT reconstruction constants: q/q_i and (q/q_i)^-1 mod q_i
        self.q_hat = [self.q // p for p in self.q_primes]
        self.q_hat_inv = [pow(self.q // p, -1, p) for p in self.q_primes]

        def col(values):
            return torch.tensor(values, dtype=torch.int64, device=self.device).reshape(-1, 1)

        self._q = col(self.q_primes)                        # against (..., L, N)
        self._t_mod = col([self.t % q for q in self.q_primes])

    @property
    def slots(self) -> int:
        """Plaintext slots per ciphertext (full packing: N)."""
        return self.n

    def max_drown_noise_bits(self) -> int:
        """Noise budget check helper: log2(q / (2t)) must exceed the drowned
        noise magnitude for correct decryption."""
        return (self.q // (2 * self.t)).bit_length() - 1

    def __hash__(self):
        return hash((self.n, self.t, self.q_primes[0], len(self.q_primes)))

    def __eq__(self, other):
        return (isinstance(other, BgvParams) and other.n == self.n
                and other.t == self.t and other.q_primes == self.q_primes)

    # -- serialization (`params.rs:70-95` serde parity) --------------------
    def to_dict(self) -> dict:
        return {
            "n": self.n,
            "t": self.t,
            "q_bits": self.q_primes[0].bit_length(),
            "n_q_primes": len(self.q_primes),
            "drown_sec": self.drown_sec,
            "cbd_k": self.cbd_k,
        }

    @classmethod
    def from_dict(cls, d: dict, device=None) -> "BgvParams":
        return cls(d["n"], d["t"], d["q_bits"], d["n_q_primes"],
                   d["drown_sec"], d["cbd_k"], device=device)


def test_params(n: int = 1024, device=None) -> BgvParams:
    """Small parameter set for tests: ~29-bit plaintext prime, 6x30-bit q."""
    t = find_primes(1, order=2 * n, bits=29)[0]
    return BgvParams(n, t, device=device)


test_params.__test__ = False  # a factory, not a test, where tests import it
