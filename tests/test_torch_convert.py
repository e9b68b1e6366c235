"""Round trips of the state converters (`ark_mpc_tpu_torch/convert.py`), and
offline material carried from the JAX package into the port."""

import numpy as np
import pytest
import torch

import ark_mpc_tpu as ref
import ark_mpc_tpu_torch as port
from ark_mpc_tpu_torch import convert
from ark_mpc_tpu_torch.algebra.scalar import BaseFelt, Scalar

torch.set_num_threads(1)


@pytest.mark.parametrize("field", [Scalar, BaseFelt], ids=lambda f: f.__name__)
@pytest.mark.parametrize("shape", [(), (7,), (3, 4)])
def test_field_roundtrip(field, shape):
    rng = np.random.default_rng(60)
    x = field.random(shape, rng, device="cpu")
    arr = convert.from_field(x)
    assert arr.dtype == np.uint32 and arr.shape == (16,) + shape
    back = convert.to_field(arr, field, device="cpu")
    assert torch.equal(back.limbs, x.limbs)
    assert back.to_ints() == x.to_ints()


def test_field_from_reference():
    """A reference Scalar's limbs become the same port Scalar."""
    vals = [0, 1, 12345, ref.Scalar.spec.modulus - 1]
    got = convert.to_field(convert.from_field(ref.Scalar.from_ints(vals)),
                           device="cpu")
    assert got.to_ints() == vals
    assert torch.equal(got.limbs, Scalar.from_ints(vals, device="cpu").limbs)


def test_to_field_rejects_bad_limbs():
    with pytest.raises(ValueError, match="limb axis"):
        convert.to_field(np.zeros((8, 2), np.uint32), device="cpu")
    with pytest.raises(ValueError, match="16-bit"):
        convert.to_field(np.full((16, 2), 1 << 16, np.uint32), device="cpu")


def test_share_roundtrip():
    src = port.TrustedDealerSource(1, seed=3, device="cpu")
    sh = src.next_shared_value_batch(9)
    pair = convert.from_share(sh)
    back = convert.to_share(pair, device="cpu")
    assert torch.equal(back.share.limbs, sh.share.limbs)
    assert torch.equal(back.mac.limbs, sh.mac.limbs)


@pytest.mark.parametrize("party", [0, 1])
def test_export_matches_between_packages(party):
    """Exported dealer material is identical whichever package drew it."""
    sizes = [4, 9]
    got = convert.export_source(port.TrustedDealerSource(party, seed=5,
                                                         device="cpu"), sizes)
    want = convert.export_source(ref.TrustedDealerSource(party, seed=5), sizes)
    np.testing.assert_array_equal(got["mac_key_share"], want["mac_key_share"])
    for tg, tw in zip(got["triples"], want["triples"]):
        for (gs, gm), (ws, wm) in zip(tg, tw):
            np.testing.assert_array_equal(gs, ws)
            np.testing.assert_array_equal(gm, wm)


def test_served_source_serves_in_order():
    material = convert.export_source(
        port.TrustedDealerSource(0, seed=6, device="cpu"), [3, 5])
    src = convert.ServedSource(material, device="cpu")
    np.testing.assert_array_equal(convert.from_field(src.get_mac_key_share()),
                                  material["mac_key_share"])
    with pytest.raises(ValueError, match="shape"):
        src.next_triplet_batch(5)
    for n, want in zip([3, 5], material["triples"]):
        for sh, (s, m) in zip(src.next_triplet_batch(n), want):
            np.testing.assert_array_equal(convert.from_share(sh)[0], s)
            np.testing.assert_array_equal(convert.from_share(sh)[1], m)
    with pytest.raises(RuntimeError, match="no triple batches left"):
        src.next_triplet_batch(1)
    with pytest.raises(NotImplementedError):
        src.next_shared_value_batch(1)


def test_reference_material_drives_the_port_fabric():
    """Triples exported from the reference's dealer, served to the port's
    fabric: a public-input product opens right and its shares equal the
    reference's own run bit for bit."""
    xs, ys = [3, 10, 77], [5, 6, 2 ** 200]
    material = [convert.export_source(ref.TrustedDealerSource(pid, seed=9), [3])
                for pid in (0, 1)]

    def prog(fabric):
        kw = {"device": fabric.device} if isinstance(fabric, port.MpcFabric) else {}
        x = fabric.share_public(fabric.field.from_ints(xs, **kw))
        y = fabric.share_public(fabric.field.from_ints(ys, **kw))
        z = fabric.mul(x, y)
        return fabric.open_authenticated(z).to_ints(), convert.from_share(z)

    got = port.execute_mock_mpc(
        prog, offline_factory=lambda pid: convert.ServedSource(material[pid],
                                                           device="cpu"),
        device="cpu")
    want = ref.execute_mock_mpc_dealer(prog, seed=9)
    for (gv, (gs, gm)), (wv, (ws, wm)) in zip(got, want):
        assert gv == wv == [x * y % ref.Scalar.spec.modulus for x, y in zip(xs, ys)]
        np.testing.assert_array_equal(gs, ws)
        np.testing.assert_array_equal(gm, wm)
