"""The port's gadgets and evaluation domain against the JAX package (CPU).

`bit_xor`, `bit_xor_public` and `prefix_product` (eager) and the domain's
FFT/IFFT (public and share-wise) get the same inputs in both packages and
must give identical opened values and share limbs; the traced gadgets must
give what the eager ones give (the reference's traced-gadget test is
`slow`).
"""

import random

import numpy as np
import torch

import ark_mpc_tpu as ref
import ark_mpc_tpu_torch as port
from ark_mpc_tpu import gadgets as rgadgets
from ark_mpc_tpu.algebra.domain import EvaluationDomain as RDomain
from ark_mpc_tpu_torch import gadgets as pgadgets
from ark_mpc_tpu_torch.algebra.domain import EvaluationDomain as PDomain

torch.set_num_threads(1)

L = port.Scalar.spec.modulus
rng = random.Random(83)
N = 4  # the batch width of tests/test_torch_scheduler.py: jitted reference ops are reused
A_BITS = [rng.randrange(2) for _ in range(N)]
B_BITS = [rng.randrange(2) for _ in range(N)]
VALS = [rng.randrange(1, L) for _ in range(N)]
N_DOM = 12  # divides 132
COEFFS = [rng.randrange(L) for _ in range(N_DOM)]


def is_port(fabric) -> bool:
    return isinstance(fabric, port.MpcFabric)


def ints(fabric, vals):
    if is_port(fabric):
        return fabric.field.from_ints(vals, device=fabric.device)
    return fabric.field.from_ints(vals)


def share_in(fabric, vals, sender):
    return fabric.share_values(ints(fabric, vals) if fabric.party_id == sender
                               else None, sender=sender, n=len(vals))


def limbs(x) -> np.ndarray:
    if isinstance(x.limbs, torch.Tensor):
        return x.limbs.cpu().numpy().astype(np.uint32)
    return np.asarray(x.limbs)


def prog_gadgets(fabric):
    g = pgadgets if is_port(fabric) else rgadgets
    sa, sb = share_in(fabric, A_BITS, 0), share_in(fabric, B_BITS, 1)
    sv = share_in(fabric, VALS, 0)
    outs = [g.bit_xor(fabric, sa, sb), g.bit_xor_public(fabric, sa, ints(fabric, B_BITS)),
            g.prefix_product(fabric, sv, defer_check=True)]
    res = {"open": [fabric.open_authenticated(o, defer=True).to_ints() for o in outs],
           "limbs": [limbs(x) for o in outs for x in (o.share, o.mac)]}
    fabric.verify_deferred()
    if is_port(fabric):  # the traced forms, in one circuit
        tr = fabric.tracer()
        ta, tb, tv = tr.wrap(sa), tr.wrap(sb), tr.wrap(sv)
        handles = [g.bit_xor(fabric, ta, tb).open(),
                   g.bit_xor_public(fabric, ta, ints(fabric, B_BITS)).open(),
                   g.prefix_product(fabric, tv).open()]
        tr.run()
        res["traced"] = [h.value.to_ints() for h in handles]
    return res


def test_gadgets_match_reference():
    got = port.execute_mock_mpc_dealer(prog_gadgets, device="cpu")
    want = ref.execute_mock_mpc_dealer(prog_gadgets)
    xor = [u ^ v for u, v in zip(A_BITS, B_BITS)]
    prefix = [int(np.prod(VALS[:i + 1], dtype=object)) % L for i in range(len(VALS))]
    for party in (0, 1):
        assert got[party]["open"] == want[party]["open"] == [xor, xor, prefix]
        for g, w in zip(got[party]["limbs"], want[party]["limbs"]):
            np.testing.assert_array_equal(g, w)
        assert got[party]["traced"] == [xor, xor, prefix]


def test_evaluation_domain_matches_reference():
    pd, rd = PDomain(N_DOM, device="cpu"), RDomain(N_DOM)
    assert pd.group_gen == rd.group_gen
    pc = port.Scalar.from_ints(COEFFS, device="cpu")
    evals = pd.fft(pc)
    np.testing.assert_array_equal(limbs(evals), limbs(rd.fft(ref.Scalar.from_ints(COEFFS))))
    w = pd.group_gen
    assert evals.to_ints() == [sum(c * pow(w, i * j, L) for j, c in enumerate(COEFFS)) % L
                               for i in range(N_DOM)]
    assert pd.ifft(evals).to_ints() == COEFFS

    def prog(fabric):
        dom = pd if is_port(fabric) else rd
        sh = share_in(fabric, COEFFS, 0)
        tf = dom.fft_shares(sh)
        rt = dom.fft_shares(tf, forward=False)
        return [limbs(tf.share), limbs(tf.mac)], fabric.open_authenticated(rt).to_ints()

    got, want = port.execute_mock_mpc_dealer(prog, device="cpu"), ref.execute_mock_mpc_dealer(prog)
    for party in (0, 1):
        for g, w_ in zip(got[party][0], want[party][0]):
            np.testing.assert_array_equal(g, w_)
        assert got[party][1] == COEFFS


def test_domain_sizes():
    for bad in (5, 8, 264):
        try:
            PDomain(bad, device="cpu")
        except ValueError:
            continue
        raise AssertionError(f"domain size {bad} was accepted")
    assert PDomain(132, device="cpu").n == 132
