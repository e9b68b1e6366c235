"""Non-FHE offline protocols: public coins, RLC MAC check, inverse tuples,
shared bits.

Counterpart of `ark_mpc_tpu/offline/lowgear/protocols.py` (`offline-phase/
src/lowgear/{shared_random,mac_check,inverse_tuples,shared_bits,
multiplication}.rs`).  These are two-party protocols over the fabric's
transport; their Beaver rounds consume triples from the fabric's offline
source (a dealer, or the prep stores LowGear is building).  They draw from
the fabric's host generator in the reference's order, so the same
generator states give the same values bit for bit.

Unlike the reference, the peer's public-coin limbs go through
`MpcFabric._from_wire`: a (16, n) array of 16-bit limbs, every value below
l, or `AuthenticationError` before any coin is used.
"""

from __future__ import annotations

from ...algebra import limbs as lb
from ...algebra.fields import SCALAR_FIELD
from ...algebra.scalar import Scalar
from ...algebra.share import ScalarShare
from ...fabric import commitment
from ...fabric.context import MpcFabric, _wire
from ...fabric.errors import AuthenticationError
from ...parallel.step import mac_check_fold
from ..errors import InvalidCommitment, InvalidMac

L = SCALAR_FIELD.modulus


def public_coin_scalars(fabric: MpcFabric, n: int) -> Scalar:
    """Shared public randomness via commit-reveal
    (`lowgear/shared_random.rs:38-53`): both parties sample, commit, reveal;
    coins are the sums."""
    dev = fabric.device
    mine = Scalar.random(n, fabric.rng, device=dev)
    blinder = Scalar.random((), fabric.rng, device=dev)
    comm = commitment.commit(mine, blinder)
    peer_comm = fabric.exchange_scalars(comm)
    (peer_canon,) = fabric._exchange_arrays([_wire(Scalar(mine.canonical_limbs()))])
    peer = fabric._from_wire(peer_canon, (n,))   # validated before any use
    peer = Scalar(lb.to_mont(SCALAR_FIELD, peer.limbs))
    peer_blinder = fabric.exchange_scalars(blinder)
    if not commitment.verify(peer, peer_blinder, peer_comm):
        raise InvalidCommitment("public coin commitment failed to verify")
    return mine + peer


def open_and_check_macs(fabric: MpcFabric, shares: ScalarShare) -> Scalar:
    """Open a batch and verify MACs with ONE random-linear-combination
    check (`lowgear/mac_check.rs:14-48`): fold t = sum r_i (key v_i - mac_i)
    and commit-reveal the fold shares; abort unless they sum to zero."""
    n = shares.size
    flat = shares.reshape(n)
    opened = fabric.open(flat)
    coins = public_coin_scalars(fabric, n)
    t = mac_check_fold(fabric.mac_key, opened, flat.mac, coins)
    try:
        fabric._run_mac_check(t.reshape(1))
    except AuthenticationError as e:  # surface as the offline error type
        raise InvalidMac(str(e)) from e
    return opened


def beaver_mul(fabric: MpcFabric, lhs: ScalarShare, rhs: ScalarShare) -> ScalarShare:
    """Offline-phase Beaver multiplication (`lowgear/multiplication.rs:13-66`):
    the online fabric's round, consuming stored triples."""
    return fabric.mul(lhs, rhs)


def generate_inverse_tuples(fabric: MpcFabric, n: int):
    """([a], [a^{-1}]) pairs (`lowgear/inverse_tuples.rs:20-41`): blind-mul
    two random batches, open + MAC-check the product, invert publicly,
    unblind: (ab)^{-1} * b = a^{-1}."""
    a = fabric.random_shared_scalars(n)
    b = fabric.random_shared_scalars(n)
    ab = beaver_mul(fabric, a, b)
    ab_open = open_and_check_macs(fabric, ab)
    a_inv = b.mul_public(ab_open.inverse())
    return a, a_inv


def _sqrt_mod_l_host(values: list[int]) -> list[int]:
    """Tonelli-Shanks square roots mod l (2-adicity 2), host-side; offline
    path only (`lowgear/shared_bits.rs` uses arkworks sqrt)."""
    q = (L - 1) >> 2    # l - 1 = 2^2 * q
    z = 2               # the least non-residue
    while pow(z, (L - 1) // 2, L) != L - 1:
        z += 1
    c0 = pow(z, q, L)
    out = []
    for v in values:
        if v == 0:
            out.append(0)
            continue
        t = pow(v, q, L)
        r = pow(v, (q + 1) // 2, L)
        c, m = c0, 2
        while t != 1:
            # the least i with t^(2^i) = 1
            i, tt = 0, t
            while tt != 1:
                tt = tt * tt % L
                i += 1
            b = pow(c, 1 << (m - i - 1), L)
            r = r * b % L
            c = b * b % L
            t = t * c % L
            m = i
        out.append(r)
    return out


def generate_shared_bits(fabric: MpcFabric, n: int) -> ScalarShare:
    """Uniform shared bits via the QR trick (`lowgear/shared_bits.rs:22-46`):
    square a random share, open, take a canonical public sqrt s, then
    [b'] = [r]/s is +-1 and [b] = ([b'] + 1) / 2."""
    dev = fabric.device
    r = fabric.random_shared_scalars(n)
    r2 = beaver_mul(fabric, r, r)
    r2_open = open_and_check_macs(fabric, r2)
    roots = _sqrt_mod_l_host(r2_open.to_ints())
    # both parties must pick the SAME canonical root: min(root, l - root)
    roots = [min(v, (L - v) % L) for v in roots]
    s_inv = Scalar.from_ints(roots, device=dev).inverse()
    signed = r.mul_public(s_inv)  # in {-1, +1} (or 0 w.p. ~0)
    shifted = fabric.add_public(signed, Scalar.ones((n,), device=dev))
    return shifted.mul_public(Scalar.from_ints(pow(2, -1, L), device=dev))


def generate_shared_randomness(fabric: MpcFabric, n: int) -> ScalarShare:
    """Authenticated random shares from the fabric's source (dealer mode).
    bgv-mode LowGear samples locally and authenticates homomorphically
    instead (`triplets_l.generate_authenticated_randomness_l`,
    `lowgear/shared_random.rs:56-71`)."""
    return fabric.random_shared_scalars(n)
