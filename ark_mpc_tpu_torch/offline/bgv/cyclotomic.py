"""BGV rings over general cyclotomics: the RNS residue layer and the dense
m = 132 prototype ring.

Counterpart of `ark_mpc_tpu/offline/bgv/cyclotomic.py`.  A ring element is
an ``int64`` tensor of residues (..., L, phi), canonical in [0, q_i) for
each RNS prime q_i = 1 (mod m); it crosses to the JAX package and the wire
as the same array in uint32 (`convert.py`).

  - `RnsRing` holds what both ring backends share: the RNS basis, pointwise
    residue arithmetic and the lifts of small signed integers, plaintext
    limbs and ZK word planes into residues.  Subclasses say what the
    canonical form is (`lift_residues`, `coefficients`).
  - `CyclotomicRing` is the reference's round-1 prototype: coefficients mod
    Phi_m, products by dense per-prime DFT, inverse-DFT and reduction
    matrices (m = 132: phi = 40, 40 F_l slots; m = 35 gives the d = 2
    GF(l^2) slot structure at toy size).
  - The GF(l^2) helpers build slot maps for d = 2 (`powerful.py` uses them).

Every value equals the reference's; the per-prime matrix products run as
exact float64 products (`ops/modular32.residue_matmul`), the F_l matrix
products as `ops/matmul.mont_matmul`.  Ring constants are built on the host
once per ring and kept on the ring's device.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ...algebra import limbs as lb
from ...algebra.fields import SCALAR_FIELD
from ...algebra.scalar import Scalar
from ...device import resolve_device
from ...ops import modular32 as m32
from ...ops.modular32 import PrimeSpec, find_primes

L_MOD = SCALAR_FIELD.modulus
I64 = torch.int64


def _phi(m: int) -> int:
    out, t, d = m, m, 2
    while d * d <= t:
        if t % d == 0:
            out -= out // d
            while t % d == 0:
                t //= d
        d += 1
    if t > 1:
        out -= out // t
    return out


def _cyclotomic_poly(m: int) -> list[int]:
    """Integer coefficients of Phi_m(X) via repeated division of X^m - 1."""
    def poly_div(num, den):
        num = num[:]
        out = [0] * (len(num) - len(den) + 1)
        for i in range(len(out) - 1, -1, -1):
            coef = num[i + len(den) - 1] // den[-1]
            out[i] = coef
            for j, dv in enumerate(den):
                num[i + j] -= coef * dv
        if any(num):
            raise ArithmeticError("nonzero remainder")
        return out

    cache: dict[int, list[int]] = {1: [-1, 1]}

    def phi_poly(k: int) -> list[int]:
        if k in cache:
            return cache[k]
        num = [0] * (k + 1)
        num[0], num[k] = -1, 1
        res = num
        for d in range(1, k):
            if k % d == 0:
                res = poly_div(res, phi_poly(d))
        cache[k] = res
        return res

    return phi_poly(m)


def _slot_degree(m: int) -> int:
    """d = ord_m(l) for the supported cases d in {1, 2}."""
    r = L_MOD % m
    if r == 1:
        return 1
    if (r * r) % m == 1:
        return 2
    raise ValueError(f"ord_{m}(l) > 2 unsupported (got neither 1 nor 2)")


def _dense(rows, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(rows, dtype=np.int64), device=device)


class RnsRing:
    """Residue arithmetic over an RNS basis (the layer both backends share).

    Subclasses set `m`, `phi`, `t`, `cbd_k` and call `_init_basis`; they
    define `lift_residues` (coefficient residues -> canonical form) and
    `coefficients` (canonical form -> coefficient residues)."""

    def _init_basis(self, q_primes: list[int], device) -> None:
        self.device = resolve_device(device)
        self.q_primes = q_primes
        self.q_specs = tuple(PrimeSpec(q) for q in q_primes)
        self.q = math.prod(q_primes)
        self.q_hat = [self.q // p for p in q_primes]
        self.q_hat_inv = [pow(self.q // p, -1, p) for p in q_primes]
        q_t = torch.tensor(q_primes, dtype=I64, device=self.device)
        self._q = q_t.reshape(-1, 1)           # against (..., L, phi)
        self._q3 = q_t.reshape(-1, 1, 1)       # against (L, N, phi)
        # plaintext lift weights 2^(16 j) mod q_i, (L, 16)
        self.limb_weights = torch.tensor(
            [[pow(2, 16 * j, q) for j in range(lb.NLIMBS)] for q in q_primes],
            dtype=I64, device=self.device)
        self.t_mod_q = [self.t % q for q in q_primes]
        self.neg_t_mod_q = [(-self.t) % q for q in q_primes]
        self._t_col = torch.tensor(self.t_mod_q, dtype=I64, device=self.device).reshape(-1, 1)
        self._neg_t_col = torch.tensor(self.neg_t_mod_q, dtype=I64,
                                       device=self.device).reshape(-1, 1)

    def __hash__(self):
        return hash((self.m, self.q_primes[0], len(self.q_primes)))

    def __eq__(self, other):
        return (type(other) is type(self) and other.m == self.m
                and other.q_primes == self.q_primes)

    # -- per-prime matrix products ----------------------------------------
    def _apply(self, mats3: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """(..., L, in) -> (..., L, out): one per-prime matrix on the last
        axis (`mats3` from `modular32.split_matrices`)."""
        batch = x.shape[:-2]
        xl = x.movedim(-2, 0).reshape(len(self.q_primes), -1, x.shape[-1])
        y = m32.residue_matmul(xl, mats3, self._q3)
        return y.reshape((y.shape[0],) + batch + (y.shape[-1],)).movedim(0, -2)

    # -- pointwise residue ops ---------------------------------------------
    def zero(self, batch: tuple = ()) -> torch.Tensor:
        return torch.zeros(batch + (len(self.q_primes), self.phi), dtype=I64,
                           device=self.device)

    def add(self, a, b):
        s = a + b
        return torch.where(s >= self._q, s - self._q, s)

    def sub(self, a, b):
        d = a - b
        return torch.where(d < 0, d + self._q, d)

    def scalar_mul_t(self, a):
        """Multiply by the plaintext modulus l (per-prime constant)."""
        return a * self._t_col % self._q

    # -- lifts into RNS residues ---------------------------------------------
    def lift_signed(self, coeffs):
        """Small signed integer coefficients (..., phi) -> canonical form."""
        c = torch.as_tensor(coeffs, device=self.device).to(I64)
        return self.lift_residues(torch.remainder(c.unsqueeze(-2), self._q))

    def lift_plaintext_limbs(self, limbs):
        """Canonical plaintext limbs (16, ..., phi) -> canonical form,
        CENTERED mod l: values above l/2 lift as value - l."""
        x = limbs.to(I64)
        half = lb.int_to_limbs(L_MOD // 2 + 1)
        # v >= l//2 + 1, most significant limb first
        gt = torch.zeros_like(x[0], dtype=torch.bool)
        eq = torch.ones_like(gt)
        for i in reversed(range(lb.NLIMBS)):
            gt |= eq & (x[i] > int(half[i]))
            eq &= x[i] == int(half[i])
        is_high = (gt | eq).unsqueeze(-2)
        # v mod q_i = sum_j limb_j 2^(16 j) mod q_i: float64 sums < 2^51, exact
        flat = x.reshape(lb.NLIMBS, -1).T.to(torch.float64)
        v = (flat @ self.limb_weights.T.to(torch.float64)).to(I64)   # (N, L)
        v = torch.remainder(v, self._q.T).T.reshape(
            (len(self.q_primes),) + x.shape[1:]).movedim(0, -2)
        v_neg = self.add(v, self._neg_t_col.expand_as(v))
        return self.lift_residues(torch.where(is_high, v_neg, v))

    def _word_residues(self, words, wraps_below: int | None = None):
        """Signed base-2^48 word planes (..., phi, W) -> coefficient residues
        (..., L, phi) of sum_w d_w 2^(48 w).  With `wraps_below`, a digit
        below it counts 2^64 more (the reference's biased uint64 lift)."""
        d = torch.as_tensor(np.asarray(words, dtype=np.int64), device=self.device)
        acc = None
        for w in range(d.shape[-1]):
            dw = d[..., w].unsqueeze(-2)
            r = torch.remainder(dw, self._q)
            if wraps_below is not None:
                r = self.add(r, (dw < wraps_below) * self._pow2_col(64))
            if w:
                r = r * self._pow2_col(48 * w) % self._q
            acc = r if acc is None else self.add(acc, r)
        return acc

    def _pow2_col(self, e: int) -> torch.Tensor:
        return torch.tensor([pow(2, e, q) for q in self.q_primes], dtype=I64,
                            device=self.device).reshape(-1, 1)

    def lift_words(self, words):
        """Signed 48-bit word planes (..., phi, W) int64 -> canonical form
        (the ZKPoK word-form lift; exact)."""
        return self.lift_residues(self._word_residues(words))

    # -- host-side CRT -------------------------------------------------------
    def to_centered_ints(self, poly) -> list[int]:
        """Canonical form (L, phi) -> centered integer coefficients (host)."""
        arr = self.coefficients(poly).cpu().numpy()
        if arr.ndim != 2:
            raise ValueError(f"expected one (L, phi) element, got shape {arr.shape}")
        out = []
        for j in range(self.phi):
            v = 0
            for i, p in enumerate(self.q_primes):
                v += self.q_hat[i] * (self.q_hat_inv[i] * int(arr[i, j]) % p)
            v %= self.q
            if v > self.q // 2:
                v -= self.q
            out.append(v)
        return out


class CyclotomicRing(RnsRing):
    """Precomputed transforms for Z_q[X]/Phi_m(X) over an RNS basis
    (coefficient-form elements)."""

    def __init__(self, m: int, n_q_primes: int = 20, q_bits: int = 30,
                 cbd_k: int = 10, drown_sec: int = 40, device=None):
        self.m = m
        self.phi = _phi(m)
        # slot structure: d = ord_m(l) determines the slot field GF(l^d)
        self.d = _slot_degree(m)
        self.cbd_k = cbd_k
        self.drown_sec = drown_sec
        self.t = L_MOD
        self._init_basis(find_primes(n_q_primes, order=m, bits=q_bits), device)

        phi_poly = _cyclotomic_poly(m)
        assert len(phi_poly) == self.phi + 1

        # --- per-prime DFT / inverse-DFT / reduction matrices (plain) -------
        dft_l, idft_l, red_l = [], [], []
        for qq in self.q_primes:
            w = m32.primitive_root_of_unity(qq, m)
            dft = np.zeros((m, self.phi), dtype=np.int64)
            for i in range(m):
                wi = pow(w, i, qq)
                v = 1
                for k in range(self.phi):
                    dft[i, k] = v
                    v = v * wi % qq
            m_inv = pow(m, -1, qq)
            w_inv = pow(w, -1, qq)
            idft = np.zeros((m, m), dtype=np.int64)
            for i in range(m):
                vi = pow(w_inv, i, qq)
                v = m_inv % qq
                for k in range(m):
                    idft[i, k] = v
                    v = v * vi % qq
            # reduction: X^j mod Phi_m as a (phi,) column for each j < m
            red = np.zeros((self.phi, m), dtype=np.int64)
            cur = [0] * self.phi
            cur[0] = 1
            for j in range(m):
                for k in range(self.phi):
                    red[k, j] = cur[k] % qq
                top = cur[-1]
                cur = [0] + cur[:-1]
                if top:
                    for k in range(self.phi):
                        cur[k] = (cur[k] - top * phi_poly[k]) % qq
            dft_l.append(dft)
            idft_l.append(idft)
            red_l.append(red)
        # (L, m, phi), (L, m, m), (L, phi, m)
        self.dft = _dense(dft_l, self.device)
        self.idft = _dense(idft_l, self.device)
        self.red = _dense(red_l, self.device)
        self._dft3 = m32.split_matrices(self.dft)
        self._idft3 = m32.split_matrices(self.idft)
        self._red3 = m32.split_matrices(self.red)

        # --- slot maps over F_l ---------------------------------------------
        # d=1: slots = evaluations at the phi primitive m-th roots in F_l.
        # d=2: roots live in GF(l^2); one orbit representative per conjugate
        #      pair {z^j, z^(j l)} prescribes one F_l slot.
        prim = [j for j in range(m) if math.gcd(j, m) == 1]
        if self.d == 1:
            w_l = _find_root_of_order(L_MOD, m)
            assert len(prim) == self.phi
            self.prim_idx = prim
            eval_rows = [[pow(w_l, j * k, L_MOD) for k in range(self.phi)]
                         for j in prim]
            inv_rows = _invert_matrix_mod(eval_rows, L_MOD)
            self.slots = self.phi
            enc, dec = inv_rows, eval_rows
        else:
            zeta = _gf2_root_of_order(m)
            reps, seen = [], set()
            for j in prim:
                if j in seen:
                    continue
                reps.append(j)
                seen.add(j)
                seen.add(j * (L_MOD % m) % m)
            assert len(reps) == self.phi // 2
            self.prim_idx = reps
            self.slots = self.phi // 2
            # M p = (x ; 0): rows = re/im parts of z^(j*k)
            re_rows, im_rows = [], []
            for j in reps:
                zj = _gf2_pow(zeta, j)
                re, im = [], []
                cur = (1, 0)
                for _ in range(self.phi):
                    re.append(cur[0])
                    im.append(cur[1])
                    cur = _gf2_mul(cur, zj)
                re_rows.append(re)
                im_rows.append(im)
            m_inv = _invert_matrix_mod(re_rows + im_rows, L_MOD)
            enc = [[m_inv[i][j] for j in range(self.slots)] for i in range(self.phi)]
            dec = re_rows
        self.encode_mat = Scalar.from_ints(np.array(enc, dtype=object), device=self.device)
        self.decode_mat = Scalar.from_ints(np.array(dec, dtype=object), device=self.device)

    # -- ring operations ---------------------------------------------------
    def lift_residues(self, coeffs_rns):
        """Per-prime coefficient residues are this ring's canonical form."""
        return coeffs_rns

    def coefficients(self, a):
        return a

    def mul(self, a, b):
        """Polynomial product mod Phi_m: DFT -> pointwise -> IDFT -> reduce."""
        prod = self._apply(self._dft3, a) * self._apply(self._dft3, b) % self._q
        return self._apply(self._red3, self._apply(self._idft3, prod))

    # -- double-CRT (evaluation-form) pathway ------------------------------
    @functools.cached_property
    def eval_mats(self) -> torch.Tensor:
        """(L, phi, phi): values at the primitive m-th roots, per prime."""
        prim = [j for j in range(self.m) if math.gcd(j, self.m) == 1]
        rows = []
        for qq in self.q_primes:
            w = m32.primitive_root_of_unity(qq, self.m)
            rows.append([[pow(w, (j * k) % self.m, qq) for k in range(self.phi)]
                         for j in prim])
        return _dense(rows, self.device)

    @functools.cached_property
    def eval_mats_inv(self) -> torch.Tensor:
        return _dense([_invert_matrix_mod(r.tolist(), q) for r, q in
                       zip(self.eval_mats.cpu().numpy(), self.q_primes)], self.device)

    def to_eval(self, a):
        """Coefficient form (..., L, phi) -> evaluation form (..., L, phi)."""
        return self._apply(m32.split_matrices(self.eval_mats), a)

    def from_eval(self, v):
        return self._apply(m32.split_matrices(self.eval_mats_inv), v)

    # -- slots and decryption (dense F_l matrices, host CRT) ---------------
    def encode_slots(self, slots: Scalar) -> Scalar:
        """F_l slot values (..., slots) -> plaintext coefficients (..., phi)."""
        return _dense_slot_map(self.encode_mat, slots)

    def decode_slots(self, coeffs: Scalar) -> Scalar:
        return _dense_slot_map(self.decode_mat, coeffs)

    def phase_to_pt(self, phase) -> Scalar:
        """Phase (..., L, phi) -> plaintext coefficients mod l by host CRT."""
        flat = phase.reshape((-1,) + tuple(phase.shape[-2:]))
        vals = [v % L_MOD for i in range(flat.shape[0]) for v in self.to_centered_ints(flat[i])]
        return Scalar.from_ints(vals, device=self.device).reshape(
            *phase.shape[:-2], self.phi)


def _dense_slot_map(mat: Scalar, x: Scalar) -> Scalar:
    """(out, in) F_l matrix applied to the last axis of x (..., in)."""
    batch = x.shape[:-1]
    cols = Scalar(x.limbs.reshape(lb.NLIMBS, -1, x.shape[-1]).transpose(1, 2))
    out = mat @ cols                                   # (out, n)
    return Scalar(out.limbs.transpose(1, 2).reshape((lb.NLIMBS,) + batch + (mat.shape[0],)))


# --- GF(l^2) host arithmetic (slot-map precompute for d = 2) ---------------


@functools.lru_cache(maxsize=None)
def _gf2_nr() -> int:
    """The least quadratic non-residue mod l: GF(l^2) = F_l[i]/(i^2 - nr)."""
    nr = 2
    while pow(nr, (L_MOD - 1) // 2, L_MOD) == 1:
        nr += 1
    return nr


def _gf2_mul(x, y):
    a, b = x
    c, d = y
    nr = _gf2_nr()
    return ((a * c + b * d % L_MOD * nr) % L_MOD, (a * d + b * c) % L_MOD)


def _gf2_pow(x, e: int):
    acc = (1, 0)
    base = x
    while e:
        if e & 1:
            acc = _gf2_mul(acc, base)
        base = _gf2_mul(base, base)
        e >>= 1
    return acc


def _gf2_root_of_order(order: int):
    """Element of GF(l^2) with multiplicative order exactly `order`."""
    assert (L_MOD * L_MOD - 1) % order == 0
    fs = m32.prime_factors(order)
    cof = (L_MOD * L_MOD - 1) // order
    g = (2, 1)
    while True:
        w = _gf2_pow(g, cof)
        if w != (1, 0) and all(_gf2_pow(w, order // p) != (1, 0) for p in fs):
            return w
        g = (g[0] + 1, g[1])


def _find_root_of_order(p: int, order: int) -> int:
    assert (p - 1) % order == 0
    fs = m32.prime_factors(order)
    g = 2
    while True:
        w = pow(g, (p - 1) // order, p)
        if w != 1 and all(pow(w, order // f, p) != 1 for f in fs):
            return w
        g += 1


def _invert_matrix_mod(rows: list[list[int]], p: int) -> list[list[int]]:
    """Gaussian elimination over F_p (host; prototype-size matrices)."""
    n = len(rows)
    a = [list(row) + [1 if i == j else 0 for j in range(n)]
         for i, row in enumerate(rows)]
    for col in range(n):
        piv = next(r for r in range(col, n) if a[r][col] % p)
        a[col], a[piv] = a[piv], a[col]
        inv = pow(a[col][col], -1, p)
        a[col] = [v * inv % p for v in a[col]]
        for r in range(n):
            if r != col and a[r][col] % p:
                f = a[r][col]
                a[r] = [(v - f * w) % p for v, w in zip(a[r], a[col])]
    return [row[n:] for row in a]
