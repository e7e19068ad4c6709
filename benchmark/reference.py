"""The plain reference that decides whether a run is correct.

Python integers and NumPy only: it imports nothing of the program, and
takes nothing the program made. From a configuration file's published
curve constants it works the evaluation domain out again, and it judges
an ENTER or EXIT by an identity that holds for every polynomial of
degree below n exactly when the evaluations are right.

- The domain (:func:`leaves`): the x-coordinates of C + i·G for
  i = 0 … n − 1, C the coset offset and G the generator doubled down to
  order n, in that order: the order of ENTER's outputs and EXIT's inputs.
- The barycentric weights (:func:`weights`): λ_j = 1 / ℓ'(x_j), where
  ℓ(X) = Π (X − x_j). A 2-isogeny ψ = u/v whose kernel is G's point of
  order 2 maps the domain two to one onto the next one, and
  ℓ(X) = v(X)^(n/2) · ℓ_next(ψ(X)) (Vélu's x-map is monic), so
  ℓ'(x_j) = v(x_j)^(n/2) · ψ'(x_j) · ℓ_next'(ψ(x_j)): n log n products
  in all, down a chain of Vélu isogenies built here from the curve
  alone.
- The check (:func:`check`): for a polynomial f of degree below n with
  coefficients c and evaluations y on the domain, and any z off it,
  Σ c_k z^k = ℓ(z) Σ_j λ_j y_j / (z − x_j). A wrong evaluation makes the
  two sides differ at all but at most n − 1 values of z, so a z drawn at
  random from the field catches it but with probability n/p per z (2^-240
  for secp256k1, 2^-15 for M31: several z there). Both sides are dot
  products with a fixed vector, taken over 16-bit limbs as float64
  matrix products, which are exact below 2^53.

Outputs are also held to their representation: every element canonical,
below p, in limbs of the configuration's width (:func:`noncanonical`).
"""

from __future__ import annotations

import random

import numpy as np

LIMB = 16  # the width of the limbs the dot products split values into


class Field:
    """A configuration's prime field and curve, from its file's constants:
    y² = x³ + a2·x² + a4·x + a6 over F_p, a generator of order
    2^two_adicity, a coset offset, the tree size n, and the width of the
    limbs the program keeps an element in."""

    def __init__(self, cfg: dict):
        self.p = int(cfg["p"])
        curve = cfg["curve"]
        self.a2, self.a4 = int(curve["a2"]) % self.p, int(curve["a4"]) % self.p
        self.a6 = int(curve["a6"]) % self.p
        gen, coset = cfg["generator"], cfg["coset_offset"]
        self.gen = (int(gen["x"]), int(gen["y"]))
        self.two_adicity = int(gen["two_adicity"])
        self.coset = (int(coset["x"]), int(coset["y"]))
        self.n = int(cfg["n"])
        self.limbs, self.limb_bits = int(cfg["limbs"]), int(cfg["limb_bits"])
        if self.n < 2 or self.n & (self.n - 1):
            raise ValueError(f"n = {self.n} is not a power of two")
        for pt in (self.gen, self.coset):
            if not self.on_curve(pt):
                raise ValueError(f"{pt} is not on the curve")

    def on_curve(self, pt) -> bool:
        x, y = pt
        p = self.p
        return (y * y - (x * x * x + self.a2 * x * x + self.a4 * x + self.a6)
                ) % p == 0

    def add(self, P, Q):
        """P + Q on the curve (None is the point at infinity)."""
        if P is None:
            return Q
        if Q is None:
            return P
        p = self.p
        (x1, y1), (x2, y2) = P, Q
        if x1 == x2:
            if (y1 + y2) % p == 0:
                return None
            lam = ((3 * x1 * x1 + 2 * self.a2 * x1 + self.a4)
                   * pow(2 * y1, -1, p)) % p
        else:
            lam = (y2 - y1) * pow(x2 - x1, -1, p) % p
        x3 = (lam * lam - self.a2 - x1 - x2) % p
        return x3, (lam * (x1 - x3) - y1) % p

    def generator(self):
        """G doubled down to order n."""
        g = self.gen
        for _ in range(self.two_adicity - (self.n.bit_length() - 1)):
            g = self.add(g, g)
        return g


def leaves(f: Field) -> list[int]:
    """x(C + i·G), i = 0 … n − 1."""
    g, pt, out = f.generator(), f.coset, []
    for _ in range(f.n):
        out.append(pt[0])
        pt = f.add(pt, g)
    if len(set(out)) != f.n:
        raise ValueError("the coset's x-coordinates are not distinct")
    return out


def batch_inv(vals: list[int], p: int) -> list[int]:
    """Inverses of nonzero values mod p, with one inversion."""
    pre, acc = [], 1
    for v in vals:
        pre.append(acc)
        acc = acc * v % p
    inv = pow(acc, -1, p)
    out = [0] * len(vals)
    for i in range(len(vals) - 1, -1, -1):
        out[i] = inv * pre[i] % p
        inv = inv * vals[i] % p
    return out


def weights(f: Field, xs: list[int]) -> list[int]:
    """λ_j = 1 / Π_{i≠j} (x_j − x_i) for the domain ``xs`` = :func:`leaves`,
    down the chain of Vélu 2-isogenies whose kernels are the points of
    order 2 of G's images."""
    p, n = f.p, len(xs)
    log_n = n.bit_length() - 1
    # x of 2^i·G, i = 0 … log n − 1: level l's kernel is (n / 2^(l+1))·G
    g, pts = f.generator(), []
    for _ in range(log_n):
        pts.append(g[0])
        g = f.add(g, g)
    kernels = [pts[log_n - 1 - lvl] for lvl in range(log_n)]
    a4, level, deriv = f.a4, list(xs), [1] * n
    while kernels:
        x0, kernels, size = kernels[0], kernels[1:], len(level)
        half = size // 2
        t = (3 * x0 * x0 + 2 * f.a2 * x0 + a4) % p
        vs = [(x - x0) % p for x in level]
        vinv = batch_inv(vs, p)
        fac = [pow(v, half, p) * (1 - t * vi * vi) % p
               for v, vi in zip(vs, vinv)]
        for j in range(n):
            deriv[j] = deriv[j] * fac[j % size] % p
        level = [(level[i] + t * vinv[i]) % p for i in range(half)]
        kernels = [(k + t * pow(k - x0, -1, p)) % p for k in kernels]  # ψ
        a4 = (a4 - 5 * t) % p
    return batch_inv(deriv, p)


def points_for(f: Field) -> int:
    """The points z a check takes: each lets a wrong polynomial through
    with probability at most n/p, and together at most 2^-64."""
    return -(-64 // (f.p.bit_length() - 1 - (f.n.bit_length() - 1)))


class Checker:
    """The reference's side of the identity at points z drawn from a seed:
    per z the vector z^k (the coefficients' side) and
    ℓ(z)·λ_j / (z − x_j) (the evaluations' side), in 16-bit limbs."""

    def __init__(self, f: Field, xs: list[int], lam: list[int], seed: int,
                 points: int):
        p, n = f.p, f.n
        self.f, self.points = f, points
        self.nl = -(-p.bit_length() // LIMB)
        rng = random.Random(f"{seed}:z")
        on = set(xs)
        zs = []
        while len(zs) < points:
            z = rng.randrange(p)
            if z not in on and z not in zs:
                zs.append(z)
        pw, mu = [], []
        for z in zs:
            acc, row = 1, []
            for _ in range(n):
                row.append(acc)
                acc = acc * z % p
            pw.append(row)
            d = [(z - x) % p for x in xs]
            ell = 1
            for v in d:
                ell = ell * v % p
            mu.append([ell * lj % p * di % p
                       for lj, di in zip(lam, batch_inv(d, p))])
        self.zs = zs
        self.powers = self._limb_matrix(pw)
        self.mu = self._limb_matrix(mu)

    def _limb_matrix(self, vecs) -> np.ndarray:
        """(n, nl·Z) float64: vector z's limbs in columns z·nl … ."""
        n, nl = self.f.n, self.nl
        cols = []
        for v in vecs:
            raw = b"".join(x.to_bytes(2 * nl, "little") for x in v)
            cols.append(np.frombuffer(raw, dtype="<u2").reshape(n, nl))
        return np.concatenate(cols, axis=1).astype(np.float64)

    def dots(self, rows: np.ndarray, mat: np.ndarray) -> list[list[int]]:
        """Σ_k rows[q, k]·vec_z[k] mod p for each row q and z: rows as
        (Q, n, nl) 16-bit limbs."""
        p, nl = self.f.p, self.nl
        part = np.matmul(rows.transpose(0, 2, 1).astype(np.float64), mat)
        part = part.reshape(rows.shape[0], nl, self.points, nl)
        part = part.astype(np.int64)  # each entry below n·2^32 ≤ 2^53
        out = []
        for q in range(rows.shape[0]):
            row = []
            for zi in range(self.points):
                s = 0
                blk = part[q, :, zi, :]
                for a in range(nl):
                    for b in range(nl):
                        s += int(blk[a, b]) << (LIMB * (a + b))
                row.append(s % p)
            out.append(row)
        return out


def to_limbs(f: Field, vals: np.ndarray) -> np.ndarray:
    """(Q, n, L) int32 elements as the program keeps them → (Q, n, nl)
    16-bit limbs of their values (limbs wider than 16 bits split; no
    reduction: a non-canonical element stays what it is)."""
    vals = np.asarray(vals).astype(np.int64)
    nl = -(-f.p.bit_length() // LIMB)
    if f.limb_bits == LIMB:
        out = vals & 0xFFFF
    else:
        per = f.limb_bits // LIMB
        out = np.stack([(vals >> (LIMB * k)) & 0xFFFF for k in range(per)],
                       axis=-1).reshape(*vals.shape[:-1], -1)
    return out[..., :nl]


def noncanonical(f: Field, vals: np.ndarray) -> int:
    """Elements of (Q, n, L) int32 limbs that are not canonical: a limb
    outside [0, 2^limb_bits), or a value of p or more."""
    v = np.asarray(vals).astype(np.int64)
    bad = ((v < 0) | (v >= (1 << f.limb_bits))).any(axis=-1)
    pl = np.array([(f.p >> (f.limb_bits * k)) & ((1 << f.limb_bits) - 1)
                   for k in range(f.limbs)], dtype=np.int64)
    # v ≥ p: at the highest limb where they differ v's is larger, or none
    ge = np.ones(v.shape[:-1], dtype=bool)
    for k in range(f.limbs):  # from the lowest limb up: the top one decides
        ge = np.where(v[..., k] > pl[k], True,
                      np.where(v[..., k] < pl[k], False, ge))
    return int((bad | ge).sum())


def check(chk: Checker, coeffs: np.ndarray, evals: np.ndarray) -> list[bool]:
    """Whether each polynomial's evaluations are its coefficients'
    (coeffs, evals: (Q, n, L) int32 as the program keeps them), by the
    identity at every z of ``chk``."""
    f = chk.f
    left = chk.dots(to_limbs(f, coeffs), chk.powers)
    right = chk.dots(to_limbs(f, evals), chk.mu)
    return [a == b for a, b in zip(left, right)]
