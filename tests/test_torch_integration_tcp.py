"""The port's two-process integration driver over real TCP, spawned from
pytest (`python -m ark_mpc_tpu_torch.integration --device cpu`).

Party 1 listens, party 0 dials, on a free port; both run the named cases
over one TLS connection and must report the same results, all "ok", the
malicious-abort cases included."""

import json
import os
import socket
import subprocess
import sys

import pytest

import ark_mpc_tpu.integration as ref_integration
import ark_mpc_tpu_torch.integration as port_integration
from ark_mpc_tpu.integration import cases as _ref_cases  # noqa: F401  (fills REGISTRY)
from ark_mpc_tpu_torch.integration import cases as _port_cases  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUBSET = ["share_and_open_authenticated", "beaver_mul_batch", "deferred_check_folded",
          "point_share_open", "malicious_bad_mac_aborts",
          "malicious_folded_check_aborts"]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_pair(extra, timeout):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "ark_mpc_tpu_torch.integration", "--device", "cpu",
           "--port", str(_free_port()), "--timeout", str(timeout), "--quiet", *extra]
    p1 = subprocess.Popen(cmd + ["--party", "1"], env=env, cwd=REPO,
                          stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        p0 = subprocess.run(cmd + ["--party", "0"], env=env, cwd=REPO,
                            capture_output=True, text=True, timeout=timeout)
        out1, err1 = p1.communicate(timeout=timeout)
    finally:
        if p1.poll() is None:
            p1.kill()
            p1.communicate()
    assert p0.returncode == 0, f"party 0 failed:\n{p0.stdout}\n{p0.stderr[-3000:]}"
    assert p1.returncode == 0, f"party 1 failed:\n{out1}\n{err1[-3000:]}"
    r0 = json.loads(p0.stdout.strip().splitlines()[-1])
    r1 = json.loads(out1.strip().splitlines()[-1])
    assert r0 == r1
    bad = {k: v for k, v in r0.items() if v != "ok"}
    assert not bad, f"failing integration cases: {bad}"
    return r0


def test_registry_names_match_reference():
    """The reference's registry in full, its slow dealer-free LowGear case
    included and registered as slow in both."""
    assert set(port_integration.REGISTRY) == set(ref_integration.REGISTRY)
    slow = {name for name, f in port_integration.REGISTRY.items()
            if getattr(f, "__slow__", False)}
    assert slow == {name for name, f in ref_integration.REGISTRY.items()
                    if getattr(f, "__slow__", False)} == {"lowgear_dealer_free_e2e"}


def test_registry_subset_over_tls():
    r = _run_pair(["--tests", ",".join(SUBSET)], timeout=300)
    assert sorted(r) == sorted(SUBSET)


def test_full_registry_over_tls():
    """All 33 fast cases (~50 s on one CPU core a party); the slow case runs
    only when named."""
    r = _run_pair([], timeout=600)
    assert len(r) == len(port_integration.REGISTRY) - 1
    assert "lowgear_dealer_free_e2e" not in r


def test_lowgear_dealer_free_e2e_over_tls():
    """The dealer-free flow between two processes over TLS: key exchange
    with proofs, LowGear at m = 132, an online product on the prep."""
    r = _run_pair(["--tests", "lowgear_dealer_free_e2e"], timeout=600)
    assert r == {"lowgear_dealer_free_e2e": "ok"}


def test_driver_defaults_to_cuda():
    """Without `--device`, the driver runs on the card, and without a card
    it exits with an error before it opens a socket."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", "ark_mpc_tpu_torch.integration",
                          "--party", "1", "--port", str(_free_port()), "--timeout", "5"],
                         env=env, cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "CUDA is not available" in out.stderr
