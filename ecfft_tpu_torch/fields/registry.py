"""Field instantiations: the API surface the reference exposes per field.

A jax-free copy of ``ecfft_tpu/fields/registry.py`` (every class and
function here has its original's source, tested). Left out: the curve
search ``field_from_curve_search``, which is not on the port's path.

Each supported field carries hardcoded curve constants and knows how to
produce the FFTree ingredients (leaf evaluation domain + isogeny x-map
chain). Each ``FieldSpec`` fixes the limb decomposition (16-bit limbs, so
every partial product is exact in 32 bits) and the Montgomery constants
(R = 2^(16·L)).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ecfft_tpu_torch.errors import CurveError, SizeError, UnknownFieldError
from ecfft_tpu_torch.ec.curve import (
    GoodCurve,
    Point,
    RationalMap,
    ShortWeierstrass,
    coset_leaves,
    find_isogeny_chain,
    find_isogeny_chain_velu,
)

LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1


@dataclass(frozen=True)
class FieldSpec:
    """Static description of a prime field and its device representation."""

    name: str
    p: int
    num_limbs: int  # device limb count
    montgomery: bool  # device values stored as a·R mod p
    limb_bits: int = LIMB_BITS  # bits per limb (m31 packs p in one 32-bit limb)

    @property
    def r(self) -> int:
        return 1 << (LIMB_BITS * self.num_limbs)

    @property
    def r_mod_p(self) -> int:
        return self.r % self.p

    @property
    def r2_mod_p(self) -> int:
        return self.r * self.r % self.p

    @property
    def n_prime(self) -> int:
        """-p^{-1} mod 2^LIMB_BITS (Montgomery reduction constant)."""
        return (-pow(self.p, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)

    @property
    def fold_terms(self) -> tuple[tuple[int, int], ...] | None:
        """Sparse base-2^16 digits of R mod p for pseudo-Mersenne folding.

        2^(16·L) ≡ Σ d_t·2^(16·off_t) (mod p); the device mul folds
        product columns ≥ L back in with these terms. Digit-sum bound
        (Σ d_t < 2^11) guarantees every fold product fits uint32 even for
        non-canonical columns < 2^21 (see device._fold). Returns None for
        primes outside that bound — device.mul then takes the word-serial
        Montgomery-scan fallback, so ANY odd prime works (matching the
        reference's any-prime-field claim, README.md:2-4), just slower.
        """
        rem = self.r_mod_p
        terms = []
        i = 0
        while rem:
            d = rem & LIMB_MASK
            if d:
                terms.append((i, d))
            rem >>= LIMB_BITS
            i += 1
        if sum(d for _, d in terms) >= (1 << 11):
            return None
        return tuple(terms)


    def to_montgomery(self, a: int) -> int:
        return a * self.r % self.p if self.montgomery else a % self.p

    def from_montgomery(self, a: int) -> int:
        return (
            a * pow(self.r, -1, self.p) % self.p if self.montgomery else a % self.p
        )

    def to_limbs(self, a: int) -> list[int]:
        """Split the (possibly Montgomery-form) value into device limbs."""
        mask = (1 << self.limb_bits) - 1
        return [(a >> (self.limb_bits * i)) & mask for i in range(self.num_limbs)]

    def from_limbs(self, limbs) -> int:
        return sum(int(l) << (self.limb_bits * i) for i, l in enumerate(limbs))


def spec_for_prime(p: int, name: str | None = None) -> "FieldSpec":
    """FieldSpec for an arbitrary odd prime: 16-bit limbs, canonical form,
    pseudo-Mersenne folds when the prime allows, Montgomery-scan
    otherwise."""
    num_limbs = max((p.bit_length() + LIMB_BITS - 1) // LIMB_BITS, 1)
    return FieldSpec(
        name=name or f"fp_{p % 100000}_{p.bit_length()}b",
        p=p,
        num_limbs=num_limbs,
        montgomery=False,
    )


# --- M31: Mersenne-31 field -------------------------------------------------
# /root/reference/src/lib.rs:190-215. Device fast path is a single uint32
# (no Montgomery needed: reduction mod 2^31-1 is shift-add).

M31_P = (1 << 31) - 1

M31 = FieldSpec(name="m31", p=M31_P, num_limbs=1, montgomery=False, limb_bits=32)

# Supersingular curve with 2^31 | #E (lib.rs:200-206)
M31_CURVE = ShortWeierstrass(1, 0, M31_P)
M31_COSET_OFFSET = Point(1048755163, 279503108, M31_CURVE)
M31_SUBGROUP_GENERATOR = Point(1273083559, 804329170, M31_CURVE)
M31_SUBGROUP_TWO_ADICITY = 28


# --- secp256k1 base field ---------------------------------------------------
# /root/reference/src/lib.rs:18-85. 16 × 16-bit limbs, canonical form with
# pseudo-Mersenne fold reduction (2^256 ≡ 2^32 + 977 mod p).

SECP_P = 2**256 - 2**32 - 977

SECP256K1 = FieldSpec(name="secp256k1", p=SECP_P, num_limbs=16, montgomery=False)

# GoodCurve with 2^36 | #E and its coset/subgroup points (lib.rs:45-59)
SECP_CURVE_A = (
    31172306031375832341232376275243462303334845584808513005362718476441963632613
)
SECP_CURVE_BB = (
    45508371059383884471556188660911097844526467659576498497548207627741160623272
)
SECP_COSET_OFFSET_X = (
    105623886150579165427389078198493427091405550492761682382732004625374789850161
)
SECP_COSET_OFFSET_Y = (
    7709812624542158994629670452026922591039826164720902911013234773380889499231
)
SECP_SUBGROUP_GEN_X = (
    41293412487153066667050767300223451435019201659857889215769525847559135483332
)
SECP_SUBGROUP_GEN_Y = (
    73754924733368840065089190002333366411120578552679996887076912271884749237510
)
SECP_SUBGROUP_TWO_ADICITY = 36


# custom fields registered at runtime: name -> (curve GoodCurve params,
# coset offset Point, subgroup generator Point, two-adicity)
CUSTOM_DOMAINS: dict[str, tuple] = {}


def register_field(name: str, p: int, curve_a: int, curve_bb: int,
                   gen_xy: tuple[int, int], coset_xy: tuple[int, int],
                   two_adicity: int) -> FieldSpec:
    """Register an arbitrary odd-prime field with a GoodCurve domain so
    ``build_fftree(name, n)`` works for it — the runtime equivalent of the
    reference's per-field hardcoded modules (lib.rs:18-215)."""
    spec = spec_for_prime(p, name)
    curve = GoodCurve.new_odd(curve_a, curve_bb, p)
    gen = Point(gen_xy[0], gen_xy[1], curve)
    coset = Point(coset_xy[0], coset_xy[1], curve)
    if not (curve.contains(gen.x, gen.y) and curve.contains(coset.x, coset.y)):
        raise CurveError(
            f"generator/coset point not on the good curve over p={p:#x}"
        )
    FIELDS[name] = spec
    CUSTOM_DOMAINS[name] = (curve, coset, gen, two_adicity)
    return spec


def build_domain(spec: FieldSpec, n: int) -> tuple[list[int], list[RationalMap]] | None:
    """Host-side FFTree ingredients: (leaves, x-map chain) for a size-n tree.

    secp256k1 path mirrors lib.rs:40-84 (GoodCurve closed-form chain);
    m31 path mirrors build_ec_fftree's Vélu search (ec.rs:498-554).
    Returns None when n exceeds the subgroup two-adicity (lib.rs:62-64,
    ec.rs:513-515).
    """
    if n < 1 or n & (n - 1):
        raise SizeError("n must be a power of two")
    log_n = n.bit_length() - 1

    if spec.name == "secp256k1":
        if log_n >= SECP_SUBGROUP_TWO_ADICITY:
            return None
        curve = GoodCurve.new_odd(SECP_CURVE_A, SECP_CURVE_BB, SECP_P)
        coset = Point(SECP_COSET_OFFSET_X, SECP_COSET_OFFSET_Y, curve)
        gen = Point(SECP_SUBGROUP_GEN_X, SECP_SUBGROUP_GEN_Y, curve)
        for _ in range(SECP_SUBGROUP_TWO_ADICITY - log_n):
            gen = gen.double()
        leaves = coset_leaves(coset, gen, n)
        chain = find_isogeny_chain(gen)
        return leaves, [iso.r for iso in chain]

    if spec.name == "m31":
        if log_n > M31_SUBGROUP_TWO_ADICITY:
            return None
        if log_n >= 32:
            raise SizeError("log n must be < 32 (ec.rs:510)")
        gen = M31_SUBGROUP_GENERATOR
        for _ in range(M31_SUBGROUP_TWO_ADICITY - log_n):
            gen = gen.double()
        maps = [iso.r for iso in find_isogeny_chain_velu(gen, log_n)]
        leaves = coset_leaves(M31_COSET_OFFSET, gen, n)
        return leaves, maps

    if spec.name in CUSTOM_DOMAINS:
        curve, coset, gen, two_adicity = CUSTOM_DOMAINS[spec.name]
        if log_n >= two_adicity:
            return None
        for _ in range(two_adicity - log_n):
            gen = gen.double()
        leaves = coset_leaves(coset, gen, n)
        chain = find_isogeny_chain(gen)
        return leaves, [iso.r for iso in chain]

    raise UnknownFieldError(f"unknown field {spec.name}")


FIELDS: dict[str, FieldSpec] = {"m31": M31, "secp256k1": SECP256K1}


def get_spec(field: "str | FieldSpec") -> FieldSpec:
    """Resolve a field name (or pass a FieldSpec through), with a typed
    error for unknown names — the public lookup every API entry uses."""
    if isinstance(field, FieldSpec):
        return field
    try:
        return FIELDS[field]
    except KeyError:
        raise UnknownFieldError(
            f"unknown field {field!r}; registered: {sorted(FIELDS)}"
        ) from None
