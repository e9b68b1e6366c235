"""Offline-phase errors (`offline-phase/src/error.rs:6-23`).

Counterpart of `ark_mpc_tpu/offline/errors.py`."""


class LowGearError(Exception):
    """Base offline-phase error."""


class InvalidMac(LowGearError):
    """MAC check failed during offline generation."""


class InvalidCommitment(LowGearError):
    """A commit-reveal opening failed to verify."""


class SacrificeError(LowGearError):
    """Triple sacrifice check failed (malicious triple)."""


class KeyExchangeError(LowGearError):
    """BGV key exchange / proof verification failed, or the peer sent
    ciphertext or key residues that are not canonical."""


class NotSetup(LowGearError):
    """Offline phase used before setup completed."""
