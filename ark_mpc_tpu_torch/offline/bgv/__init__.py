"""The BGV layer of the offline phase.  Counterpart of
`ark_mpc_tpu/offline/bgv/`, both of its halves:

  - the t-generic prototype over power-of-two rings with an NTT-friendly
    plaintext prime (`params.py`, `rns.py`, `bgv.py`, the proof
    `zkpok.py`), whose names this package exports as the reference's does;
  - BGV over the Curve25519 order l, the LowGear offline phase's
    homomorphic layer: the rings (`cyclotomic.py`, `powerful.py`), the
    cryptosystem (`bgv_l.py`), the word-form ZK proof of plaintext
    knowledge (`zkpok_words.py`) and the prototype proof over l
    (`zkpok_l.py`)."""

from .bgv import (
    Ciphertext,
    Keypair,
    add_ct,
    add_pt,
    decode_slots,
    decrypt,
    decrypt_slots,
    encode_slots,
    encrypt,
    encrypt_slots,
    keygen,
    mul_pt,
    rerandomize,
)
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
from .params import BgvParams, test_params
from .powerful import PowerfulRing
from .zkpok_words import (
    CiphertextWithProofW,
    encrypt_and_prove_batch,
    proof_from_arrays,
    proof_to_arrays,
    verify_proof,
)

__all__ = [
    "BgvParams",
    "test_params",
    "Ciphertext",
    "Keypair",
    "keygen",
    "encrypt",
    "decrypt",
    "encrypt_slots",
    "decrypt_slots",
    "encode_slots",
    "decode_slots",
    "add_ct",
    "add_pt",
    "mul_pt",
    "rerandomize",
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
