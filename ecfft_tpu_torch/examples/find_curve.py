"""Curve-search demo mirroring the reference's examples/find_curve.rs:
race parallel searches for good curves with record 2-adicity over
secp256k1's base field, printing the curve found.

    python -m ecfft_tpu_torch.examples.find_curve [k] [threads]
"""

import sys
import time

from ecfft_tpu_torch.ec.curve import GoodCurve, Point, two_adicity
from ecfft_tpu_torch.fields.registry import SECP_P
from ecfft_tpu_torch.native import find_curve_parallel


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    k = int(argv[0]) if len(argv) > 0 else 14
    threads = int(argv[1]) if len(argv) > 1 else 10
    t0 = time.time()
    res = find_curve_parallel(SECP_P, k, threads=threads)
    n, a, bb, x, y = res
    curve = GoodCurve.new_odd(a, bb, SECP_P)
    pt = Point(x, y, curve)
    assert curve.contains(x, y) and two_adicity(pt) == n
    print(f"found n={n} in {time.time()-t0:.1f}s ({threads} threads)")
    print(f"  curve: y^2 = x(x^2 + {a}x + {bb})")
    print(f"  generator: ({x}, {y})")


if __name__ == "__main__":
    main()
