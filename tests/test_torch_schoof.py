"""The port's Schoof point counting (``ecfft_tpu_torch.schoof``), a
jax-free copy of ``ecfft_tpu.schoof``: ``cardinality`` equal to the JAX
package's and to a brute-force count on small primes, the division
polynomials equal, the Endo arithmetic's parity test equal, and one
``cardinality_native`` count at M31 through the port's binding of the
native engine (the value the reference documents as correct). Tolerance:
none (exact)."""

import numpy as np
import pytest

from ecfft_tpu import schoof as jschoof
from ecfft_tpu.ec.curve import ShortWeierstrass as JCurve
from ecfft_tpu_torch import schoof as tschoof
from ecfft_tpu_torch.ec.curve import ShortWeierstrass
from ecfft_tpu_torch.fields.host import legendre

M31_P = (1 << 31) - 1


def brute_count(a, b, p):
    cnt = 1
    for x in range(p):
        r = (x * x * x + a * x + b) % p
        cnt += 1 if r == 0 else (2 if legendre(r, p) == 1 else 0)
    return cnt


@pytest.mark.parametrize("p", [101, 233, 1009])
@pytest.mark.parametrize("ab", [(1, 3), (5, 7), (2, 11), (1, 0)])
def test_cardinality_matches_the_jax_package_and_brute_force(p, ab):
    a, b = ab
    assert (4 * a**3 + 27 * b**2) % p != 0
    got = tschoof.cardinality(ShortWeierstrass(a, b, p))
    assert got == jschoof.cardinality(JCurve(a, b, p)) == brute_count(a, b, p)
    assert tschoof.has_even_order(ShortWeierstrass(a, b, p)) == \
        jschoof.has_even_order(JCurve(a, b, p)) == (got % 2 == 0)


@pytest.mark.parametrize("p", [101, 1009, M31_P])
def test_division_polynomials_match_the_jax_package(p):
    rng = np.random.RandomState(p % 1000)
    a, b = (int(v) for v in rng.randint(1, min(p, 1 << 30), size=2))
    got = tschoof.division_polynomials(ShortWeierstrass(a, b, p), 9)
    want = jschoof.division_polynomials(JCurve(a, b, p), 9)
    assert got == want


def test_frobenius_traces_match_the_jax_package():
    p, a, b = 1009, 5, 7
    for ell in (3, 5, 7):
        psi = tschoof.division_polynomials(ShortWeierstrass(a, b, p),
                                           ell)[ell]
        assert tschoof.frobenius_trace_mod_l(
            ShortWeierstrass(a, b, p), ell, psi) == \
            jschoof.frobenius_trace_mod_l(JCurve(a, b, p), ell, psi)


def test_cardinality_native_at_m31():
    assert tschoof.cardinality_native(ShortWeierstrass(8, 81, M31_P)) \
        == 2147489041
