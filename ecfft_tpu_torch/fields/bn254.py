"""BN254's base field F_q (Grumpkin's scalar field), a built-in field of
the port under the name ``bn254_fq``.

q − 1 has 2-adicity 1, so no radix-2 FFT runs over F_q: the case the
ECFFT is for (wborgeaud/ecfft-bn254 implements it over this field). Its
good curve y² = x³ + a·x² + B·x (B = b²) was found by FIND_CURVE
(``native.find_curve_parallel(q, 21, threads=8, seed=1)``), with a
subgroup of order 2^21, so trees go up to n = 2^20; the coset offset was
drawn as ``registry.field_from_curve_search`` draws one, from
``random.Random(7)``. The constants are literals: importing this module
does no curve search, only :func:`registry.register_field`'s check that
both points lie on the curve.

q has no pseudo-Mersenne fold (2^256 mod q has large base-2^16 digits),
so on a card the field takes the "cios16" kernels and keeps Montgomery
residents (``fields.device.is_mont``); inputs and outputs stay canonical.
"""

from ecfft_tpu_torch.fields.registry import register_field

NAME = "bn254_fq"
P = (
    21888242871839275222246405745257275088696311157297823662689037894645226208583
)
# y² = x³ + CURVE_A·x² + CURVE_BB·x
CURVE_A = (
    16089198554897276781110870203225144738727793962799137744021522884408837202251
)
CURVE_BB = (
    1928741085607883220354616112929427289109908242370669633731190197436037714385
)
# order 2^TWO_ADICITY
GENERATOR = (
    11577426874859481699848032587379750900757606182385911456912088510546169115713,
    8350631670870939606090973431231012261840396177408694837729559224431993705707,
)
COSET_OFFSET = (
    6215087815076330926179520016461010917137519558660815034878824735059242618923,
    13988605465690689660097227148556841629053491151754191511648088890690344811944,
)
TWO_ADICITY = 21

BN254_FQ = register_field(NAME, P, CURVE_A, CURVE_BB, GENERATOR, COSET_OFFSET,
                          TWO_ADICITY)
