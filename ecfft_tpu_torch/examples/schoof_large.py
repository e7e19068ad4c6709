"""Large-prime Schoof point counting via the native engine.

Counts points on y² = x³ + ax + b over progressively larger prime
fields with ``cardinality_native`` (per-ℓ Frobenius traces in C++,
CRT-accumulated in Python). Each count is validated by the Hasse bound
and by N·P = O for random curve points. The reference's Schoof
(examples/schoofs.rs:30-71) runs at m31 (31-bit) scale only; this runs
the same algorithm family at 61..256-bit scale.

    python -m ecfft_tpu_torch.examples.schoof_large [max_bits]
"""

import math
import random
import sys
import time

from ecfft_tpu_torch.ec.curve import Point, ShortWeierstrass
from ecfft_tpu_torch.fields.host import sqrt_mod
from ecfft_tpu_torch.schoof import cardinality_native

# Mersenne primes keep the script self-contained (no primality search);
# the trace math in the native engine is generic over any ≤256-bit prime.
CASES = [
    (61, (1 << 61) - 1),
    (89, (1 << 89) - 1),
    (107, (1 << 107) - 1),
    (127, (1 << 127) - 1),
    # 2^255 - 19 (curve25519's prime): a fresh 255-bit count
    (255, (1 << 255) - 19),
]


def check(curve: ShortWeierstrass, n: int) -> None:
    p = curve.p
    assert abs(p + 1 - n) <= 2 * math.isqrt(p) + 1, "Hasse bound violated"
    rng = random.Random(7)
    checked = 0
    while checked < 2:
        x = rng.randrange(p)
        rhs = (x * x * x + curve.a * x + curve.b) % p
        y = sqrt_mod(rhs, p)
        if y is None:
            continue
        assert (Point(x, y, curve) * n).is_zero(), "N·P != O"
        checked += 1


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    max_bits = int(argv[0]) if argv else 127
    for bits, p in CASES:
        if bits > max_bits:
            break
        curve = ShortWeierstrass(5, 7, p)
        t0 = time.time()
        n = cardinality_native(curve)
        dt = time.time() - t0
        check(curve, n)
        print(f"p ~ 2^{bits}: #E = {n}  ({dt:.1f} s, validated)", flush=True)


if __name__ == "__main__":
    main()
