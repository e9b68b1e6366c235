"""How often a drowned prototype ciphertext fails to decrypt, in each package.

    python tests/_drowning_rate.py [TRIALS] [N]

encrypts TRIALS random slot vectors at `test_params(N)` (default 40 at
N = 1024), rerandomizes each (drowning noise of drown_sec + 20 bits) and
decrypts, in the JAX package and in the port (on the CPU), and prints the
number of wrong decryptions of each and the primes' distances below 2^30.
The reference lifts its 30-bit drowning words through `from_signed_coeffs`,
whose uint32 cast wraps a word below -q_i through 2^32
(`ark_mpc_tpu/offline/bgv/rns.py:79-81`, `:130-138`); the port lifts them
exactly (`ark_mpc_tpu_torch/offline/bgv/rns.py`, `sample_uniform_bounded`).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from ark_mpc_tpu.offline.bgv import bgv as ref_bgv  # noqa: E402
from ark_mpc_tpu.offline.bgv import params as ref_params  # noqa: E402
from ark_mpc_tpu_torch.offline.bgv import bgv as port_bgv  # noqa: E402
from ark_mpc_tpu_torch.offline.bgv import params as port_params  # noqa: E402


def main(trials: int, n: int) -> None:
    rp, pp = ref_params.test_params(n), port_params.test_params(n, device="cpu")
    rng = np.random.default_rng(1)
    kp = ref_bgv.keygen(rp, jax.random.PRNGKey(0))
    ref_bad = 0
    for i in range(trials):
        s = rng.integers(0, rp.t, size=n, dtype=np.uint32)
        ct = ref_bgv.encrypt_slots(rp, kp.pk_a, kp.pk_b, s, jax.random.PRNGKey(10 + i))
        ct = ref_bgv.rerandomize(rp, kp.pk_a, kp.pk_b, ct, jax.random.PRNGKey(1000 + i))
        ref_bad += int((ref_bgv.decrypt_slots(rp, kp.sk, ct) != s).any())
    gen = torch.Generator().manual_seed(0)
    pkp = port_bgv.keygen(pp, gen)
    port_bad = 0
    for _ in range(trials):
        s = rng.integers(0, pp.t, size=n, dtype=np.uint32)
        ct = port_bgv.encrypt_slots(pp, pkp.pk_a, pkp.pk_b, s, gen)
        ct = port_bgv.rerandomize(pp, pkp.pk_a, pkp.pk_b, ct, gen)
        port_bad += int((port_bgv.decrypt_slots(pp, pkp.sk, ct) != s).any())
    print(f"N = {n}, primes below 2^30 by {[(1 << 30) - q for q in rp.q_primes]}")
    print(f"wrong decryptions after rerandomize: reference {ref_bad} of {trials}, "
          f"port {port_bad} of {trials}")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 40,
         int(sys.argv[2]) if len(sys.argv) > 2 else 1024)
