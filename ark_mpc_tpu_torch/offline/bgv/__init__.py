"""BGV over the Curve25519 order l: the rings, the cryptosystem and the
word-form ZK proof of plaintext knowledge (the LowGear offline phase's
homomorphic layer).  Counterpart of the l-side of
`ark_mpc_tpu/offline/bgv/`; the reference's t-generic prototype (`bgv.py`,
`params.py`, `rns.py`, `zkpok.py`) is not ported."""

from .bgv_l import (
    CiphertextL,
    KeypairL,
    RelinKeyL,
    add_ct_l,
    add_pt_l,
    decode_slots_l,
    decrypt_l,
    default_ring,
    encode_slots_l,
    encrypt_l,
    encrypt_returning_randomness_l,
    encrypt_with_randomness_l,
    gen_relin_key_l,
    keygen_l,
    medium_ring,
    mul_ct_l,
    mul_pt_l,
    production_ring,
    rerandomize_l,
    rlwe_secure_128,
)
from .cyclotomic import CyclotomicRing
from .powerful import PowerfulRing
from .zkpok_words import (
    CiphertextWithProofW,
    encrypt_and_prove_batch,
    proof_from_arrays,
    proof_to_arrays,
    verify_proof,
)

__all__ = [
    "CyclotomicRing",
    "PowerfulRing",
    "CiphertextL",
    "KeypairL",
    "RelinKeyL",
    "default_ring",
    "medium_ring",
    "production_ring",
    "rlwe_secure_128",
    "keygen_l",
    "encode_slots_l",
    "decode_slots_l",
    "encrypt_with_randomness_l",
    "encrypt_l",
    "encrypt_returning_randomness_l",
    "decrypt_l",
    "add_ct_l",
    "add_pt_l",
    "mul_pt_l",
    "rerandomize_l",
    "gen_relin_key_l",
    "mul_ct_l",
    "CiphertextWithProofW",
    "encrypt_and_prove_batch",
    "verify_proof",
    "proof_to_arrays",
    "proof_from_arrays",
]
