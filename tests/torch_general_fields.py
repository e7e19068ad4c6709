"""The general-prime fields the port's tests share (imported by
``tests/test_torch_general_prime*.py`` and ``tests/test_torch_cuda.py``;
no JAX here, so the card's tests can import it too).

Each curve was found by FIND_CURVE (``ecfft_tpu_torch.native
.find_curve_parallel``), its coset point drawn as
``field_from_curve_search`` draws it:

- "gp_m61": M61 = 2^61 − 1, 4 limbs, a fold (F = 8);
- "gp_band": 2^256 − 1053, 16 limbs, a fold whose digit lies past 2^10;
- "gp_cios3": 0xff8000000f, 3 limbs (odd), no fold: Montgomery residents;
- "gp_cios13": a 200-bit prime, 13 limbs (odd), no fold;
- "gp_stark": the STARK prime, 16 limbs, no fold, on a curve of 2-adicity
  8 (trees up to n = 128): most of its curves stop the host's isogeny
  chain builder after a few levels (``ec/curve.py::find_isogeny_chain``,
  the reference's), this one builds.
"""

from ecfft_tpu_torch.fields import registry as treg

# name: (p, a, B = b², subgroup generator, coset offset, 2-adicity)
CURVES = {
    "gp_m61": (
        (1 << 61) - 1, 0xecdc0b8148d8108, 0x187d577ae1410e52,
        (0x149c57a8c28cbfbc, 0x24cf3f3202f1f3),
        (0x19ac27c6d8f16adf, 0x1ee5e2c2e9610638), 20),
    "gp_band": (
        (1 << 256) - 1053,
        0x9a56acd64f31e54d30ff201bf9201bfa8ba605452db839c9d9e90ceaeac684c0,
        0x78ee8aefb331e12e025d5c44ffbf47e1da7d0d58ee3d06ecb4a7db04f8f175c7,
        (0xda62ee4d341bb59c3d5bc41b48c0db9ce1d692d412e0f796df23973b79f8a21f,
         0x7c02beb9b0c6c0128ffa1fed0c8df362d5a301e938b18adbc2cd240ca6540ed3),
        (0x35bf992dc9e9c616612e7696a6cecc1b78e510617311d8a3c2ce6f447ed4d57b,
         0xbd43f7a6711539d84b0701ca0a528608b3765cc4f6b8c4610d291119e08761ed),
        17),
    "gp_cios3": (
        0xff8000000f, 0x3f2f3e08fa, 0x4c03da9c52,
        (0xaf6176c937, 0x15a9a765ad), (0xcdd8f16adf, 0x5c24f4ed43), 14),
    "gp_cios13": (
        0xd9cd502d42af1ffe0de8d79f49af6d114c4a6f188a424e61cb,
        0x156425c5244c746cccfb5a1fbd51575e705dc17ec44fcecaa5,
        0x81a00041e06f254041685fa1d7ae8a674f95f1f82b8629da3b,
        (0x36fc711e2bab16219646077eda21fc4fb3380e7f230776583b,
         0x1f4c8606415d7202ee1dc7daa9045922f6e6eb5b26f25f6a08),
        (0x7e1e2feb89414c343c1027c4d1c386bbc4cd613e30d8f16adf,
         0xb5e528edf47a8687b256827cba3aee6d657c5a3e3dad290240), 17),
    "gp_stark": (
        0x0800000000000011000000000000000000000000000000000000000000000001,
        0x276c3ba7a5469663bba61b7515617483019bed536f2ff36ca9d2c597db35806,
        0x268f61479721c2aa7bc6988386b9ed730329a700a2b298494c7a2c5a6fe5834,
        (0x258406a94bf6765534ab649821db3015fec276b8559215893d8fb352030b1dc,
         0x5b50b29fbb77d00bc20f88085dcd951798e8ebd313b0ccd544fa46d88b3e9f0),
        (0x2b49104d5e341245c6e433715ba2bdd177219d30e7a269fd95bafc8f2a4d27b,
         0x473fbf87787645043eea47a846443f5960ce51781c798590eae67c846e6b6db),
        8),
}
FORMS = {"gp_m61": "fold4", "gp_band": "fold16", "gp_stark": "cios16",
         "gp_cios3": "cios3", "gp_cios13": "cios13"}
MONT = ["gp_stark", "gp_cios3", "gp_cios13"]


def register(*registries):
    """Register every field with each registry module (the port's, and
    the JAX package's where a test holds the two together); returns the
    port's specs by name."""
    for reg in (treg, *registries):
        for name, curve in CURVES.items():
            reg.register_field(name, *curve)
    return {name: treg.FIELDS[name] for name in CURVES}
