"""Dense polynomials over F_p as python-int coefficient lists.

A jax-free copy of ``ecfft_tpu/utils/poly.py``: arithmetic (add, sub,
mul, divmod, gcd, extended gcd, powers mod a polynomial), the root finding
that ``ec/curve.py`` needs (square-free factorization → distinct-degree
factorization → Cantor–Zassenhaus splitting) and Horner evaluation, which
Schoof's point count (``schoof.py``) and the examples use. Every function
here has the same source as its original (tested).

A polynomial is a ``list[int]`` of coefficients, low degree first, with no
trailing zeros (the zero polynomial is ``[]``). All functions take the
modulus ``p`` explicitly.
"""

from __future__ import annotations

import random

from ecfft_tpu_torch.fields.host import inv_mod

Poly = list  # list[int]


def trim(f: Poly) -> Poly:
    while f and f[-1] == 0:
        f.pop()
    return f


def degree(f: Poly) -> int:
    """Degree; -1 for the zero polynomial (ark-poly reports 0, callers here
    must handle the difference explicitly)."""
    return len(f) - 1


def is_zero(f: Poly) -> bool:
    return len(f) == 0


def add(f: Poly, g: Poly, p: int) -> Poly:
    n = max(len(f), len(g))
    out = [0] * n
    for i, c in enumerate(f):
        out[i] = c
    for i, c in enumerate(g):
        out[i] = (out[i] + c) % p
    return trim(out)


def sub(f: Poly, g: Poly, p: int) -> Poly:
    n = max(len(f), len(g))
    out = [0] * n
    for i, c in enumerate(f):
        out[i] = c
    for i, c in enumerate(g):
        out[i] = (out[i] - c) % p
    return trim(out)


def scale(f: Poly, k: int, p: int) -> Poly:
    k %= p
    return trim([c * k % p for c in f])


def mul(f: Poly, g: Poly, p: int) -> Poly:
    if not f or not g:
        return []
    out = [0] * (len(f) + len(g) - 1)
    for i, a in enumerate(f):
        if a == 0:
            continue
        for j, b in enumerate(g):
            out[i + j] += a * b
    return trim([c % p for c in out])


def divmod_poly(num: Poly, den: Poly, p: int) -> tuple[Poly, Poly]:
    """Quotient and remainder (cf. ark-poly divide_with_q_and_r used at
    reference/src/utils.rs:185-192)."""
    if is_zero(den):
        raise ZeroDivisionError("division by zero polynomial")
    if len(num) < len(den):
        return [], list(num)
    rem = list(num)
    lead_inv = inv_mod(den[-1], p)
    q = [0] * (len(num) - len(den) + 1)
    for i in range(len(num) - len(den), -1, -1):
        c = rem[i + len(den) - 1]
        if c == 0:
            continue
        factor = c * lead_inv % p
        q[i] = factor
        for j, d in enumerate(den):
            rem[i + j] = (rem[i + j] - factor * d) % p
    return trim(q), trim(rem)


def div_rem(num: Poly, den: Poly, p: int) -> Poly:
    """Returns ``num % den`` (reference/src/utils.rs:185-192)."""
    return divmod_poly(num, den, p)[1]


def gcd(a: Poly, b: Poly, p: int) -> Poly:
    """Monic-normalized polynomial GCD (reference/src/utils.rs:132-141)."""
    while not is_zero(b):
        a, b = b, div_rem(a, b, p)
    if is_zero(a):
        return []
    return scale(a, inv_mod(a[-1], p), p)


def xgcd(a: Poly, b: Poly, p: int) -> tuple[Poly, Poly, Poly]:
    """Extended Euclid: (s, t, g) with a*s + b*t = g, g monic
    (reference/src/utils.rs:147-182)."""
    s, old_s = [], [1]
    r, old_r = list(b), list(a)
    while not is_zero(r):
        q, _ = divmod_poly(old_r, r, p)
        old_r, r = r, sub(old_r, mul(q, r, p), p)
        old_s, s = s, sub(old_s, mul(q, s, p), p)
    if not is_zero(b):
        t = divmod_poly(sub(old_r, mul(old_s, a, p), p), b, p)[0]
    else:
        t = []
    if is_zero(old_r):
        return old_s, t, old_r
    lead_inv = inv_mod(old_r[-1], p)
    return scale(old_s, lead_inv, p), scale(t, lead_inv, p), scale(old_r, lead_inv, p)


def pow_mod(a: Poly, exp: int, modulus: Poly, p: int) -> Poly:
    """(a^exp) % modulus via square-and-multiply
    (reference/src/utils.rs:195-211)."""
    res = [1]
    acc = div_rem(a, modulus, p)
    while exp:
        if exp & 1:
            res = div_rem(mul(res, acc, p), modulus, p)
        acc = div_rem(mul(acc, acc, p), modulus, p)
        exp >>= 1
    return res


def derivative(f: Poly, p: int) -> Poly:
    """Formal derivative (reference/src/utils.rs:214-222)."""
    return trim([i * c % p for i, c in enumerate(f)][1:])


def evaluate(f: Poly, x: int, p: int) -> int:
    """Horner evaluation."""
    acc = 0
    for c in reversed(f):
        acc = (acc * x + c) % p
    return acc


def rand_poly(d: int, p: int, rng: random.Random) -> Poly:
    """Random polynomial of degree ≤ d (reference/src/utils.rs:224-226)."""
    return trim([rng.randrange(p) for _ in range(d + 1)])


def square_free_factors(f: Poly, p: int) -> Poly:
    """f / gcd(f, f') — the square-free part
    (reference/src/utils.rs:118-127)."""
    fp = derivative(f, p)
    if is_zero(fp):
        return list(f)
    return divmod_poly(f, gcd(f, fp, p), p)[0]


def distinct_degree_factors(f: Poly, p: int) -> dict[int, Poly]:
    """Maps degree d → product of all monic irreducible degree-d factors.

    Input must be square-free (reference/src/utils.rs:52-78). Prime
    fields only (matching the reference's own TODO at utils.rs:61).
    """
    x = [0, 1]
    res: dict[int, Poly] = {}
    f_star = list(f)
    i = 1
    while degree(f_star) >= 2 * i:
        xp = pow_mod(x, p, f_star, p)
        xpi = pow_mod(xp, p ** (i - 1), f_star, p) if i > 1 else xp
        # x^(p^i) - x mod f*
        g = gcd(f_star, sub(xpi, x, p), p)
        if degree(g) > 0:
            f_star = divmod_poly(f_star, g, p)[0]
            assert i not in res
            res[i] = g
        i += 1
    if degree(f_star) > 0:
        res[degree(f_star)] = f_star
    elif not res:
        res[1] = f_star
    return res


def equal_degree_factorization(f: Poly, d: int, p: int,
                               rng: random.Random | None = None) -> list[Poly]:
    """Cantor–Zassenhaus probabilistic splitting of a product of degree-d
    irreducibles (reference/src/utils.rs:82-113)."""
    if d == 0:
        return []
    rng = rng or random.Random(0xECFF7)
    n = degree(f)
    r = n // d
    factors = [list(f)]
    while len(factors) < r:
        h = rand_poly(n - 1, p, rng)
        e = (p ** d - 1) // 2
        g = sub(pow_mod(h, e, f, p), [1], p)
        nxt: list[Poly] = []
        for factor in factors:
            gr = gcd(g, factor, p)
            if degree(gr) > 0 and gr != factor:
                nxt.append(divmod_poly(factor, gr, p)[0])
                nxt.append(gr)
            else:
                nxt.append(factor)
        factors = nxt
    return factors


def find_roots(f: Poly, p: int, rng: random.Random | None = None) -> list[int]:
    """All distinct roots of f in F_p, sorted ascending
    (reference/src/utils.rs:25-44)."""
    sf = square_free_factors(f, p)
    ddf = distinct_degree_factors(sf, p)
    d1 = ddf.get(1)
    if d1 is None:
        return []
    linear = equal_degree_factorization(d1, 1, p, rng)
    roots = []
    for factor in linear:
        assert degree(factor) == 1
        # factor = c + x (monic) → root = -c
        roots.append((-factor[0]) % p)
    roots.sort()
    return roots
