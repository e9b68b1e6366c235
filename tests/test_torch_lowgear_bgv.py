"""The port's prototype two-party BGV LowGear pipeline (`ark_mpc_tpu_torch/
offline/lowgear/setup.py`'s `run_key_exchange`, `triplets_bgv.py`) on the
CPU: key exchange, then triple generation with the ZK-gated enc(a)
exchange, homomorphic cross products and authentication, over the BGV test
plaintext field F_t.

The cases of `tests/test_lowgear_bgv.py`: c = a b mod t, every MAC equal
to key x value, and a pair (a, b', c' = a b') with the same a.  They run
through the port's `execute_mock_mpc` at a small ring (N = 32) in the fast
tier; at the reference's N = 256 they are slow, as the reference's are,
and there one party runs the JAX package and the other the port, over
one in-process channel: the two packages' frames, proofs and ciphertexts
must interoperate for the triples to come out right.  The port's own
rules: a corrupted peer proof, or peer residues that are not canonical,
raise `KeyExchangeError`, and a key exchange without a generator draws a
fresh seed.
"""

import queue
import threading

import numpy as np
import pytest
import torch

from ark_mpc_tpu_torch.fabric import messages
from ark_mpc_tpu_torch.fabric.simulator import execute_mock_mpc
from ark_mpc_tpu_torch.offline.bgv.params import test_params
from ark_mpc_tpu_torch.offline.errors import KeyExchangeError
from ark_mpc_tpu_torch.offline.lowgear.setup import run_key_exchange
from ark_mpc_tpu_torch.offline.lowgear.triplets_bgv import (
    generate_triple_pairs,
    generate_triples,
)

torch.set_num_threads(1)

FIELDS = ("a", "b", "c", "a_mac", "b_mac", "c_mac")


def host(trip) -> dict:
    """A triple's slot vectors (either package's, on the CPU) as Python ints."""
    return {k: np.asarray(getattr(trip, k)).astype(object) for k in FIELDS}


def check_triples(t0: dict, t1: dict, key: int, t: int) -> None:
    a, b, c = ((t0[k] + t1[k]) % t for k in "abc")
    assert (c == a * b % t).all(), "c != a b"
    for name, vals in (("a", a), ("b", b), ("c", c)):
        macs = (t0[f"{name}_mac"] + t1[f"{name}_mac"]) % t
        assert (macs == vals * key % t).all(), f"mac({name})"


def port_party(params, fabric_or_transport, pid: int, key_val: int, seed: int,
               with_pair: bool = True):
    transport = getattr(fabric_or_transport, "transport", fabric_or_transport)
    gen = torch.Generator(device=params.device).manual_seed(seed + pid)
    st = run_key_exchange(transport, params, np.full(params.n, key_val, dtype=np.uint32), gen)
    if not with_pair:
        return host(generate_triples(transport, st, key_val, gen)), None
    trip, pair = generate_triple_pairs(transport, st, key_val, gen)
    return host(trip), host(pair)


def run_port(n: int, with_pair: bool = True):
    params = test_params(n, device="cpu")
    keys = [12345 + 99 * pid for pid in (0, 1)]
    (t0, p0), (t1, p1) = execute_mock_mpc(
        lambda f: port_party(params, f, f.party_id, keys[f.party_id], 300, with_pair),
        device="cpu")
    return params, sum(keys) % params.t, (t0, t1), (p0, p1)


@pytest.mark.parametrize("n", [32, pytest.param(256, marks=pytest.mark.slow)])
def test_bgv_triple_pairs_share_a(n):
    """Fig. 7 pair: (a, b, c) and (a, b', c' = a b') with the SAME a, both
    authenticated under key = k0 + k1."""
    params, key, (t0, t1), (p0, p1) = run_port(n)
    check_triples(t0, t1, key, params.t)
    check_triples(p0, p1, key, params.t)
    assert ((t0["a"] + t1["a"]) % params.t == (p0["a"] + p1["a"]) % params.t).all()
    assert ((t0["b"] + t1["b"]) % params.t != (p0["b"] + p1["b"]) % params.t).any()


@pytest.mark.parametrize("n", [32, pytest.param(256, marks=pytest.mark.slow)])
def test_bgv_triples_end_to_end(n):
    params, key, (t0, t1), _ = run_port(n, with_pair=False)
    check_triples(t0, t1, key, params.t)


class Tamper:
    """A transport that rewrites the arrays of its `at`-th outgoing frame
    (1-based) with `fn(arrays)`."""

    def __init__(self, inner, at: int, fn):
        self.inner, self.at, self.fn, self.count = inner, at, fn, 0

    def exchange(self, data: bytes) -> bytes:
        self.count += 1
        if self.count == self.at:
            data = messages.encode_arrays(self.fn(messages.decode_arrays(data)))
        return self.inner.exchange(data)


def tampered_run(at: int, fn, tamperer: int = 1):
    params = test_params(32, device="cpu")

    def prog(fabric):
        transport = fabric.transport
        if fabric.party_id == tamperer:
            transport = Tamper(transport, at, fn)
        return port_party(params, transport, fabric.party_id, 7 + fabric.party_id, 40)

    return execute_mock_mpc(prog, device="cpu")


def bump_response(arrays):
    """The enc(a) proof's first ternary response, one more: within its
    bound, so only the linear check can catch it."""
    zu = arrays[5].copy()
    zu[0, 0] += 1
    return arrays[:5] + [zu] + arrays[6:]


def test_corrupted_peer_proof_raises_key_exchange_error():
    """Party 1 alters its enc(a) proof on the wire (the third frame, after
    the two of the key exchange): party 0's verification fails."""
    with pytest.raises(KeyExchangeError, match="proof of knowledge failed"):
        tampered_run(3, bump_response)


def lift_residue(arrays):
    """The first residue of the first array raised to 2^31 - 1, above
    every prime of the basis (a non-canonical encoding of the same key)."""
    first = arrays[0].copy()
    first.reshape(-1)[0] = (1 << 31) - 1
    return [first] + arrays[1:]


@pytest.mark.parametrize("at", [1, 2, 3, 4], ids=["public_key", "mac_share_ct",
                                                   "proof_ct", "product_ct"])
def test_non_canonical_peer_residues_raise_key_exchange_error(at):
    """A peer residue at or above its prime, in a public key, the MAC-share
    ciphertext, the proven ciphertext or a cross product's ciphertext,
    raises `KeyExchangeError` (the reference reads them unchecked)."""
    with pytest.raises(KeyExchangeError, match="not below their RNS primes"):
        tampered_run(at, lift_residue)


def test_malformed_peer_key_raises_key_exchange_error():
    with pytest.raises(KeyExchangeError, match="expected"):
        tampered_run(1, lambda arrays: [arrays[0][:, :-1].copy()] + arrays[1:])


def test_key_exchange_without_a_generator_draws_a_fresh_seed():
    """`gen=None` gives a new key pair each time (the reference falls back
    to one fixed key)."""
    params = test_params(32, device="cpu")

    def prog(fabric):
        states = [run_key_exchange(fabric.transport, params,
                                   np.full(params.n, 3, dtype=np.uint32)) for _ in range(2)]
        return [st.keypair.pk_a for st in states]

    for a, b in execute_mock_mpc(prog, device="cpu"):
        assert not torch.equal(a, b)


class QueueTransport:
    """One end of an in-process channel both packages' protocols can use
    (they only call `exchange`)."""

    def __init__(self, out_q: queue.Queue, in_q: queue.Queue):
        self.out_q, self.in_q = out_q, in_q

    def exchange(self, data: bytes) -> bytes:
        self.out_q.put(data)
        return self.in_q.get(timeout=1800)


@pytest.mark.slow
def test_port_and_reference_parties_make_triples_together():
    """At the reference's N = 256, party 0 runs the port and party 1 the
    JAX package over one channel: the key exchange, the proofs each side
    verifies of the other's enc(a), the cross products and the MACs give
    correct triple pairs (minutes: the reference's BGV compiles)."""
    import jax

    from ark_mpc_tpu.offline.bgv import test_params as ref_test_params
    from ark_mpc_tpu.offline.lowgear.setup import run_key_exchange as ref_key_exchange
    from ark_mpc_tpu.offline.lowgear.triplets_bgv import (
        generate_triple_pairs as ref_triple_pairs,
    )

    n, keys = 256, (5, 6)
    params, ref_params = test_params(n, device="cpu"), ref_test_params(n)
    q01, q10 = queue.Queue(), queue.Queue()
    out, errors = [None, None], []

    def party0():
        try:
            out[0] = port_party(params, QueueTransport(q01, q10), 0, keys[0], 500)
        except BaseException as err:  # noqa: BLE001 - reported below
            errors.append(err)

    def party1():
        try:
            transport = QueueTransport(q10, q01)
            st = ref_key_exchange(transport, ref_params,
                                  np.full(n, keys[1], dtype=np.uint32), jax.random.PRNGKey(301))
            trip, pair = ref_triple_pairs(transport, st, np.uint32(keys[1]),
                                          jax.random.PRNGKey(401))
            out[1] = (host(trip), host(pair))
        except BaseException as err:  # noqa: BLE001 - reported below
            errors.append(err)

    threads = [threading.Thread(target=f, daemon=True) for f in (party0, party1)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=1800)
    assert not errors, errors
    (t0, p0), (t1, p1) = out
    check_triples(t0, t1, sum(keys) % params.t, params.t)
    check_triples(p0, p1, sum(keys) % params.t, params.t)
    assert ((t0["a"] + t1["a"]) % params.t == (p0["a"] + p1["a"]) % params.t).all()
