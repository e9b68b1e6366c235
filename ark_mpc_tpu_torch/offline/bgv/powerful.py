"""Production general-m cyclotomic ring in the POWERFUL (tensor) basis.

Counterpart of `ark_mpc_tpu/offline/bgv/powerful.py`, value for value:

    R = Z[X]/Phi_m(X)  =~  (x)_a  Z[X_a]/Phi_{m_a}(X_a),   m = prod m_a
                                                     (pairwise coprime)

  - coefficients live in the powerful basis, shape (phi(m_1), ...,
    phi(m_k)) flattened in C order; the canonical (EVALUATION) form holds
    the values at the phi(m) primitive m-th roots, so ring + and x are
    pointwise (..., L, phi) residue ops;
  - coefficient <-> evaluation conversion is one dense transform per axis
    (at m = 118965 = 3 5 7 11 103 the axes have phi 2, 4, 6, 10 and 102),
    for every RNS prime in one exact float64 batched product
    (`ops/modular32.residue_matmul`);
  - the slot encode/decode maps are per-axis GF(l^2) transforms.  Each axis
    is ONE F_l matrix product (`ops/matmul.mont_matmul`) of the real 2 x 2
    block form [[Mr, nr Mi], [Mi, Mr]] against the stacked (re; im) limbs,
    where the reference loops over the axis' input columns; the field values
    are the same;
  - decryption converts RNS -> F_l on the device: k = round(sum_i c_i/q_i)
    in float64 (the reference rounds in float32; both are exact under the
    ring's 18-bit margin), then sum_i c_i (qhat_i mod l) + k (l - q mod l)
    as one float64 product into 16-bit columns, one REDC and one Montgomery
    product (the `mont_mul` kernel on the card).

Host precompute (primes, per-axis matrices and their inverses, the GF(l^2)
slot maps) is Python-int code, run once per ring.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ...algebra import limbs as lb
from ...algebra.fields import SCALAR_FIELD
from ...algebra.scalar import Scalar
from ...ops import modular32 as m32
from ...ops.matmul import mont_matmul
from ...ops.modular32 import find_primes
from .cyclotomic import (
    I64,
    L_MOD,
    RnsRing,
    _gf2_mul,
    _gf2_nr,
    _gf2_pow,
    _gf2_root_of_order,
    _slot_degree,
)

# ---------------------------------------------------------------------------
# host precompute helpers
# ---------------------------------------------------------------------------


def coprime_factors(m: int) -> list[int]:
    out, t, p = [], m, 2
    while p * p <= t:
        if t % p == 0:
            pk = 1
            while t % p == 0:
                t //= p
                pk *= p
            out.append(pk)
        p += 1
    if t > 1:
        out.append(t)
    return out


def _phi_pp(pk: int) -> int:
    """phi of a prime power."""
    p = next(d for d in range(2, pk + 1) if pk % d == 0)
    return pk - pk // p


def _units(pk: int) -> list[int]:
    return [u for u in range(1, pk) if math.gcd(u, pk) == 1]


def zk_word_counts(zk_sec: int, u_max: int, cbd_k: int) -> tuple[int, int]:
    """48-bit word counts for the ZKPoK response vectors: Wz covers the
    plaintext response bound 2^zk_sec * U * l/2, Wu the randomness/noise
    responses 2^zk_sec * U * max(1, k)."""
    log_u = max(u_max - 1, 1).bit_length()
    wz = -(-(zk_sec + 253 + log_u + 2) // 48)
    wu = -(-(zk_sec + log_u + cbd_k.bit_length() + 2) // 48)
    return wz, wu


def _inv_mat_mod_np(mat: np.ndarray, q: int) -> np.ndarray:
    """Vectorized modular Gaussian elimination (int64; q < 2^31)."""
    n = mat.shape[0]
    a = np.concatenate([mat.astype(np.int64) % q, np.eye(n, dtype=np.int64)], axis=1)
    for col in range(n):
        piv = col + int(np.nonzero(a[col:, col] % q)[0][0])
        if piv != col:
            a[[col, piv]] = a[[piv, col]]
        inv = pow(int(a[col, col]), -1, q)
        a[col] = (a[col] * inv) % q
        f = a[:, col].copy()
        f[col] = 0
        a = (a - f[:, None] * a[col][None, :]) % q
    return a[:, n:]


def _gf2_inv_mat(rows: list[list[tuple]], nr: int, p: int) -> list[list[tuple]]:
    """Gaussian elimination over GF(p^2) = F_p[i]/(i^2 - nr); entries are
    (re, im) int tuples.  Sizes <= 102, one-time per axis."""
    n = len(rows)

    def ginv(x):
        a, b = x
        d = (a * a - nr * b * b) % p
        di = pow(d, -1, p)
        return (a * di % p, (-b) * di % p)

    a = [row[:] + [(1, 0) if i == j else (0, 0) for j in range(n)]
         for i, row in enumerate(rows)]
    for col in range(n):
        piv = next(r for r in range(col, n) if a[r][col] != (0, 0))
        a[col], a[piv] = a[piv], a[col]
        iv = ginv(a[col][col])
        a[col] = [_gf2_mul(v, iv) for v in a[col]]
        for r in range(n):
            if r != col and a[r][col] != (0, 0):
                f = a[r][col]
                a[r] = [((v[0] - fw[0]) % p, (v[1] - fw[1]) % p)
                        for v, fw in ((v, _gf2_mul(f, w)) for v, w in zip(a[r], a[col]))]
    return [row[n:] for row in a]


def _gf2_block(mat: list[list[tuple]], nr: int, device) -> torch.Tensor:
    """GF(l^2) matrix (out x in) -> (16, 2 out, 2 in) Montgomery limbs of
    [[Mr, nr Mi], [Mi, Mr]], which maps (re; im) to the product's (re; im)."""
    re = [[v[0] for v in row] for row in mat]
    im = [[v[1] for v in row] for row in mat]
    nr_im = [[nr * v % L_MOD for v in row] for row in im]
    blk = [r + s for r, s in zip(re, nr_im)] + [r + s for r, s in zip(im, re)]
    return Scalar.from_ints(np.array(blk, dtype=object), device=device).limbs


# ---------------------------------------------------------------------------
# the ring
# ---------------------------------------------------------------------------


class PowerfulRing(RnsRing):
    """General-m cyclotomic ring, eval-form resident, powerful-basis
    coefficients.  Interface-compatible with `CyclotomicRing` for `bgv_l`.

    Element representation (the double-CRT / eval form): int64 tensor of
    shape (..., L, phi), residues mod each RNS prime of the evaluations at
    the phi primitive m-th roots (C order over the per-axis unit tuples).
    As uint32 it is the wire format.
    """

    def __init__(self, m: int, n_q_primes: int | None = None,
                 q_bits: int = 30, cbd_k: int = 10, drown_sec: int = 128,
                 zk_sec: int = 128, u_max: int = 128, device=None):
        self.m = m
        self.zk_sec = zk_sec
        self.u_max = u_max
        self.factors = coprime_factors(m)
        self.axis_phis = [_phi_pp(f) for f in self.factors]
        self.phi = math.prod(self.axis_phis)
        self.cbd_k = cbd_k
        self.drown_sec = drown_sec
        self.t = L_MOD
        self.d = _slot_degree(m)
        self.slots = self.phi // self.d
        self.units = [_units(f) for f in self.factors]

        # --- noise budget (docs/security_params.md); independent of q -------
        # drowning hides the adversarial noise admitted by the ZK proof:
        #   pre-drown phase/t <= max(B_z/t, gamma*(B_u*k + B_e))
        #                        * gamma * (l/2) * 4,   gamma <= m.
        wz, wu = zk_word_counts(zk_sec, u_max, cbd_k)
        self.zk_wz, self.zk_wu = wz, wu
        log_gamma = (m - 1).bit_length()
        log_bu = 48 * wu - 1
        pre_over_t = max(48 * wz - 1 - 253,
                         log_gamma + log_bu + cbd_k.bit_length() + 1) + log_gamma + 252 + 2
        self.drown_bits = drown_sec + pre_over_t + 8
        # decrypt correctness: q exceeds the drowned phase by >= 18 bits
        log2_q_needed = 253 + self.drown_bits + 18
        if n_q_primes is None:
            n_q_primes = -(-log2_q_needed // (q_bits - 1)) + 1
        q_primes = find_primes(n_q_primes, order=m, bits=q_bits)
        while sum(p.bit_length() for p in q_primes[:-1]) >= log2_q_needed:
            q_primes = q_primes[:-1]
        self._init_basis(q_primes, device)

        # --- per-prime per-axis eval/coeff matrices -----------------------
        # B_a[u, b] = w_a^(units[u] b), w_a = w^(m / m_a) of order m_a, from
        # one order-m root w, so the unit tuples enumerate each primitive
        # m-th root once.  `fwd_mats[a]`, `inv_mats[a]`: (L, phi_a, phi_a) in
        # Montgomery form (x 2^32 mod q_i), as the reference keeps them.
        fwd = [[] for _ in self.factors]
        inv = [[] for _ in self.factors]
        for qq in self.q_primes:
            w = m32.primitive_root_of_unity(qq, m)
            for a, f in enumerate(self.factors):
                wa = pow(w, m // f, qq)
                rows = np.array([[pow(wa, (u * b) % f, qq) for b in range(self.axis_phis[a])]
                                 for u in self.units[a]], dtype=np.int64)
                fwd[a].append(rows)
                inv[a].append(_inv_mat_mod_np(rows, qq))
        r = np.array([(1 << 32) % q for q in self.q_primes], dtype=np.int64)[:, None, None]
        qn = np.array(self.q_primes, dtype=np.int64)[:, None, None]
        self.fwd_mats, self.inv_mats, self._fwd3, self._inv3 = [], [], [], []
        for a in range(len(self.factors)):
            for plain, mont, split in ((np.stack(fwd[a]), self.fwd_mats, self._fwd3),
                                       (np.stack(inv[a]), self.inv_mats, self._inv3)):
                mont.append(torch.as_tensor(plain * r % qn, device=self.device))
                split.append(m32.split_matrices(torch.as_tensor(plain, device=self.device)))

        # word lift weights 2^(48 w) mod q_i (ZKPoK word-plane lifts); 16
        # words cover any response width (wz = 9 at zk_sec = 128)
        self.word_weights_q = [[pow(2, 48 * wdx, q) for wdx in range(16)]
                               for q in self.q_primes]

        # --- device CRT -> F_l decryption constants ------------------------
        # m mod l = sum_i c_i (q_hat_i mod l) - k (q mod l), where
        # c_i = a_i q_hat_inv_i mod q_i and k = round(sum_i c_i / q_i).
        self.qhatinv_mont = [self.q_hat_inv[i] * s.r % s.q for i, s in enumerate(self.q_specs)]
        self.qhat_mod_l = Scalar.from_ints([qh % L_MOD for qh in self.q_hat], device=self.device)
        self.q_mod_l = Scalar.from_ints(self.q % L_MOD, device=self.device)
        self.q_float_inv = np.array([1.0 / p for p in self.q_primes])
        self._q_float_inv = torch.as_tensor(self.q_float_inv, device=self.device)
        self._crt_weights = self._crt_weight_rows()
        self._qhat_inv_col = torch.tensor(self.q_hat_inv, dtype=I64,
                                          device=self.device).reshape(-1, 1)

        self.log2_q = sum(p.bit_length() for p in self.q_primes)
        self.budget_ok = self.log2_q >= log2_q_needed
        self._slot_maps_built = False

    def _crt_weight_rows(self) -> torch.Tensor:
        """(2L + 1, 17) float64: row i (i < L) holds the limbs of qhat_i mod
        l, row L + i the same shifted up one limb (for the high 16 bits of
        c_i), row 2L the limbs of l - (q mod l) (for k)."""
        n = len(self.q_primes)
        rows = np.zeros((2 * n + 1, lb.NLIMBS + 1), dtype=np.float64)
        for i, qh in enumerate(self.q_hat):
            limbs = lb.int_to_limbs(qh % L_MOD)
            rows[i, :lb.NLIMBS] = limbs
            rows[n + i, 1:] = limbs
        rows[2 * n, :lb.NLIMBS] = lb.int_to_limbs((L_MOD - self.q % L_MOD) % L_MOD)
        return torch.as_tensor(rows, device=self.device)

    # -- GF(l^2) machinery (seconds of host precompute at m = 118965) -------
    def _build_slot_maps(self):
        if self._slot_maps_built:
            return
        nr = _gf2_nr()
        zeta = _gf2_root_of_order(self.m)
        self.gf_fwd, self.gf_inv = [], []   # [axis] (16, 2 phi_a, 2 phi_a)
        for a, f in enumerate(self.factors):
            za = _gf2_pow(zeta, self.m // f)
            rows = [[_gf2_pow(za, (u * b) % f) for b in range(self.axis_phis[a])]
                    for u in self.units[a]]
            self.gf_fwd.append(_gf2_block(rows, nr, self.device))
            self.gf_inv.append(_gf2_block(_gf2_inv_mat(rows, nr, L_MOD), nr, self.device))

        # Frobenius orbit structure on the eval index space
        per_axis_perm = []
        for a, f in enumerate(self.factors):
            uidx = {u: i for i, u in enumerate(self.units[a])}
            per_axis_perm.append(np.array([uidx[(u * L_MOD) % f] for u in self.units[a]],
                                          dtype=np.int64))
        frob = np.arange(self.phi).reshape(self.axis_phis)
        for a, perm in enumerate(per_axis_perm):
            frob = np.take(frob, perm, axis=a)
        self.frob_perm = frob.reshape(-1)  # flat: index -> frobenius index
        if self.d == 2:
            reps = np.nonzero(np.arange(self.phi) <= self.frob_perm)[0]
            assert reps.size == self.slots
            self.slot_reps = reps
            self.slot_partner = self.frob_perm[reps]
        else:
            self.slot_reps = np.arange(self.phi)
            self.slot_partner = self.slot_reps
        self._slot_reps_t = torch.as_tensor(self.slot_reps, device=self.device)
        self._slot_partner_t = torch.as_tensor(self.slot_partner, device=self.device)
        self._slot_maps_built = True

    # -- coeff <-> eval ------------------------------------------------------
    def _apply_axes(self, mats3: list, x: torch.Tensor) -> torch.Tensor:
        """One per-prime transform per axis of (..., L, phi).  Each step
        contracts the leading axis and appends its output axis last, so after
        every axis the order is the original one."""
        batch = x.shape[:-2]
        n_q = len(self.q_primes)
        y = x.movedim(-2, 0).reshape((n_q, -1) + tuple(self.axis_phis))
        n = y.shape[1]
        for a, mat3 in enumerate(mats3):
            y = y.reshape(n_q, n, self.axis_phis[a], -1).transpose(2, 3)
            y = m32.residue_matmul(y, mat3, self._q3)
        return y.reshape((n_q,) + batch + (self.phi,)).movedim(0, -2)

    def to_eval(self, coeffs_rns):
        """Powerful-basis residues (..., L, phi) -> eval form."""
        return self._apply_axes(self._fwd3, coeffs_rns)

    def from_eval(self, ev):
        return self._apply_axes(self._inv3, ev)

    def lift_residues(self, coeffs_rns):
        """Per-prime COEFFICIENT residues (..., L, phi) -> eval form."""
        return self.to_eval(coeffs_rns)

    def coefficients(self, ev):
        return self.from_eval(ev)

    # -- ring ops (eval form, pointwise) --------------------------------------
    def mul(self, a, b):
        """Pointwise eval-form product."""
        return a * b % self._q

    def lift_words(self, words):
        """Signed 48-bit word planes (..., phi, W) int64 -> eval form (the
        ZKPoK response lift).  Values equal the reference's biased uint64
        lift, which adds 2^64 to a digit below -2^55 (the verifier rejects
        digits at or beyond 2^54 before lifting)."""
        return self.to_eval(self._word_residues(words, wraps_below=-(1 << 55)))

    # -- decryption back-end ---------------------------------------------------
    def phase_to_pt(self, phase) -> Scalar:
        """Eval-form phase (..., L, phi) -> plaintext powerful-basis
        coefficients mod l (Montgomery limbs (16, ..., phi)), on the device."""
        coeffs = self.from_eval(phase)
        n_q = len(self.q_primes)
        c = coeffs * self._qhat_inv_col % self._q          # c_i < q_i
        c = c.movedim(-2, -1).reshape(-1, n_q)             # (N, L)
        k = torch.round((c.to(torch.float64) * self._q_float_inv).sum(-1, keepdim=True)).to(I64)
        planes = torch.cat([c & 0xFFFF, c >> 16, k], dim=1).to(torch.float64)
        cols = (planes @ self._crt_weights).to(I64).T      # (17, N), each < 2^38
        x = lb._redc(SCALAR_FIELD, cols)                   # X R^-1 mod l
        r3 = lb.const_like(lb.int_to_limbs(pow(2, 768, L_MOD)), x)
        limbs = lb.mont_mul(SCALAR_FIELD, x, r3)           # X R: Montgomery form
        return Scalar(limbs.reshape((lb.NLIMBS,) + tuple(phase.shape[:-2]) + (self.phi,)))

    # -- slot maps over F_l ----------------------------------------------------
    def _gf2_axes(self, blocks: list, re: torch.Tensor) -> torch.Tensor:
        """Per-axis GF(l^2) transforms of (16, ..., phi) limbs with zero
        imaginary part -> the real part, as (16, ..., phi)."""
        shape = re.shape
        x = torch.stack([re, torch.zeros_like(re)], 1)
        x = x.reshape((lb.NLIMBS, 2, -1) + tuple(self.axis_phis))
        for a, blk in enumerate(blocks):
            y = x.movedim(3 + a, 2)                        # (16, 2, phi_a, ...)
            z = mont_matmul(SCALAR_FIELD, blk, y.reshape(lb.NLIMBS, 2 * self.axis_phis[a], -1))
            x = z.reshape(y.shape).movedim(2, 3 + a)
        return x[:, 0].reshape(shape)

    def encode_slots(self, slots: Scalar) -> Scalar:
        """F_l slot values (..., slots) -> powerful-basis plaintext
        coefficients (..., phi) via per-axis inverse GF(l^2) transforms;
        Frobenius-consistent filling makes the coefficients land in F_l."""
        self._build_slot_maps()
        flat = slots.limbs
        ev = flat.new_zeros(flat.shape[:-1] + (self.phi,))
        ev[..., self._slot_reps_t] = flat
        if self.d == 2:
            ev[..., self._slot_partner_t] = flat
        return Scalar(self._gf2_axes(self.gf_inv, ev))

    def decode_slots(self, coeffs: Scalar) -> Scalar:
        """Powerful-basis plaintext coefficients -> F_l slot values."""
        self._build_slot_maps()
        return Scalar(self._gf2_axes(self.gf_fwd, coeffs.limbs)[..., self._slot_reps_t])
