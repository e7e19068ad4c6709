"""The port's CUDA kernels on the card, against their plain PyTorch
versions (the same wrappers on CPU copies of the inputs), bit for bit,
and ENTER/EXIT on the card, by either executor, against the CPU's; the
nine M31 forms likewise, and M31's algorithms against the native engine
and the CPU; the general prime's forms (the fold form at 4 and 16 limbs,
the CIOS form at 3, 13 and 16 limbs, slack 0 among them) likewise, and
its algorithms on the card against the CPU's; the warp cascade
(``csrc/warp_cascade.cuh``) of M31 and of the word forms of one and two
words likewise, at ragged lane counts, a tile of 8 rows and 16 levels;
the one-limb fold form ("fold1", p = 97 and 64513) likewise; the NTT on
the card against the CPU and naive evaluation; a tree moved to the card
by ``place_on`` and one read from a cache directory; the device bootstrap
(``FFTree.build``) on the card against the CPU's, each ``*_unscheduled``
algorithm likewise with kernel launches, sharding over two shards of the
card, and M31's unscheduled ENTER at a size whose blocks, folded into the
lanes, would pass the M31 kernels' grid; the pair form of the self-read
and two-product kernels ("fold16" and "cios16") on the main path's window
against its plain version, and replays of ENTER and EXIT that take it
against the eager loop.

Marked ``cuda``: without a card every test here skips. This file imports
no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py
"""

import os
import sys

import pytest
import torch

from ecfft_tpu_torch import build_fftree_native
from ecfft_tpu_torch.fields.registry import FIELDS, spec_for_prime
from ecfft_tpu_torch.native import NativeFFTree
from ecfft_tpu_torch.fields import device as fd
from ecfft_tpu_torch.ops import _build, schedule, step, unrolled

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_general_fields import CURVES, FORMS, register  # noqa: E402
from torch_unscheduled_cases import CASES as UCASES  # noqa: E402
from torch_unscheduled_cases import inputs as unscheduled_inputs  # noqa: E402
from torch_unscheduled_cases import port_tree  # noqa: E402

pytestmark = pytest.mark.cuda

SPEC = FIELDS["secp256k1"]
L = SPEC.num_limbs


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _limbs(gen, *shape):
    x = torch.randint(0, 1 << 16, (*shape, L), generator=gen,
                      dtype=torch.int32)
    x[..., -1] = torch.randint(0, SPEC.to_limbs(SPEC.p)[-1], shape,
                               generator=gen, dtype=torch.int32)
    return x


@pytest.mark.parametrize("B", [1, 3, 128])
@pytest.mark.parametrize("kind", ["aff1s_ip", "aff1g_ip", "aff2g_ip"])
def test_kernel_matches_plain_version(card, kind, B):
    _kernel_against_plain(card, kind, B)


def _kernel_against_plain(card, kind, B):
    gen = torch.Generator().manual_seed(B)
    W, A, start = 384, 128, 200
    state = _limbs(gen, W, B).permute(0, 2, 1).contiguous()
    x1, x2 = (_limbs(gen, A, B).permute(0, 2, 1).contiguous()
              for _ in range(2))
    ca, cb = _limbs(gen, A), _limbs(gen, A)
    args = {"aff1s_ip": (cb, state, x2), "aff1g_ip": (cb, state, x1, x2),
            "aff2g_ip": (ca, cb, state, x1, x2)}[kind]
    wrapper = getattr(step, kind)
    want = [a.clone() for a in args]
    wrapper(SPEC, *want, start)
    got = [a.to(card) for a in args]
    before = wrapper.launches["fold16"]
    wrapper(SPEC, *got, start)
    torch.cuda.synchronize()
    assert wrapper.launches["fold16"] == before + 1
    si = 2 if kind == "aff2g_ip" else 1  # the state's place in args
    assert torch.equal(got[si].cpu(), want[si])


def test_enter_exit_on_card_match_cpu(card):
    n, gen = 256, torch.Generator().manual_seed(3)
    coeffs = _limbs(gen, 4, n)
    cpu = build_fftree_native("secp256k1", n, device="cpu")
    gpu = build_fftree_native("secp256k1", n, device=card)
    evals = gpu.enter(coeffs.to(card))
    assert torch.equal(evals.cpu(), cpu.enter(coeffs))
    assert torch.equal(gpu.exit(evals).cpu(), coeffs)


def test_enter_chunks_the_batch_when_the_card_is_short(card, monkeypatch):
    """With the card's free memory read as two lanes' worth, ENTER runs
    a batch of 4 in two chunks of 2 and still equals the CPU's."""
    n, B, gen = 256, 4, torch.Generator().manual_seed(5)
    coeffs = _limbs(gen, B, n)
    cpu = build_fftree_native("secp256k1", n, device="cpu")
    gpu = build_fftree_native("secp256k1", n, device=card).prepare()
    per_lane, fixed = schedule._chunk_bytes(gpu._schedule("enter", n)[0],
                                            L, B, n)
    free = fixed + 2 * per_lane + per_lane // 2
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (free, 80 << 30))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda device=None: 0)
    monkeypatch.setattr(torch.cuda, "memory_allocated",
                        lambda device=None: 0)
    chunks, to_state = [], schedule.to_state
    monkeypatch.setattr(schedule, "to_state", lambda b, *a: (
        chunks.append(b.shape[0]), to_state(b, *a))[1])
    evals = gpu.enter(coeffs.to(card))
    assert chunks == [2, 2]
    assert torch.equal(evals.cpu(), cpu.enter(coeffs))


def test_kernels_build_with_nvcc_alone(card, monkeypatch, tmp_path):
    """A form's library is built by nvcc at its first use, into the build
    directory; the library it makes runs the same kernels."""
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(step, "_libs", {})
    _kernel_against_plain(card, "aff2g_ip", 3)
    assert os.path.dirname(step._libs["fold16"]._name) == str(tmp_path)
    assert os.listdir(tmp_path) == ["libecfft_fold16.so"]


@pytest.mark.parametrize("B", [1, 3, 128])
@pytest.mark.parametrize("kind", ["muladd1", "muladd2"])
def test_out_of_place_kernel_matches_plain_version(card, kind, B):
    """A new window, and rows [start, start + A) of a state with x1 its
    own window (OP_AFF1S) or a buffer of its own."""
    gen = torch.Generator().manual_seed(7 + B)
    W, A, start = 520, 200, 264
    x1, x2 = (_limbs(gen, A, B).permute(0, 2, 1).contiguous()
              for _ in range(2))
    state = _limbs(gen, W, B).permute(0, 2, 1).contiguous()
    coeffs = [_limbs(gen, A) for _ in range(1 if kind == "muladd1" else 2)]
    on_card = [c.to(card) for c in coeffs]
    wrapper = getattr(step, kind)
    want, got = torch.empty_like(x1), torch.empty_like(x1, device=card)
    wrapper(SPEC, *coeffs, x1, x2, want, 0)
    before = wrapper.launches["fold16"]
    wrapper(SPEC, *on_card, x1.to(card), x2.to(card), got, 0)
    torch.cuda.synchronize()
    assert wrapper.launches["fold16"] == before + 1
    assert torch.equal(got.cpu(), want)
    for i, own in enumerate((True, False)):
        want = state.clone()
        wrapper(SPEC, *coeffs, want[start:start + A] if own else x1, x2,
                want, start)
        got = state.to(card)
        wrapper(SPEC, *on_card, got[start:start + A] if own
                else x1.to(card), x2.to(card), got, start)
        torch.cuda.synchronize()
        assert wrapper.launches["fold16"] == before + 2 + i
        assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("B", [1, 3, 128])
@pytest.mark.parametrize("spec", [SPEC, spec_for_prime(2**255 - 19)],
                         ids=["secp256k1", "ed25519"])
def test_mulss_kernel_matches_plain_version(card, spec, B):
    """The state×state product: two windows of their own, then one buffer
    as both factors (a square), with every value p − 1 in the first rows;
    rows outside the window stay."""
    gen = torch.Generator().manual_seed(13 + B)
    W, A, start = 520, 200, 264
    x1, x2 = (_limbs(gen, A, B).permute(0, 2, 1).contiguous()
              for _ in range(2))
    x1[..., -1, :] &= 0x7FFF  # below 2^255 - 19 too
    x2[..., -1, :] &= 0x7FFF
    top = torch.tensor(spec.to_limbs(spec.p - 1), dtype=torch.int32)
    x1[:8] = x2[:8] = top[:, None]
    state = _limbs(gen, W, B).permute(0, 2, 1).contiguous()
    before = step.mulss.launches["fold16"]
    for a, b in ((x1, x2), (x2, x2)):
        want = state.clone()
        step.mulss(spec, a, b, want, start)
        got = state.to(card)
        ac = a.to(card)
        step.mulss(spec, ac, ac if a is b else b.to(card), got, start)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want)
        assert not torch.equal(want, state)
    assert step.mulss.launches["fold16"] == before + 2


def test_algorithms_on_card_match_cpu(card, monkeypatch):
    """The seven other methods on the card, on each executor, against the
    CPU's plain versions at n = 1024 (the general modulus at m = 16)."""
    n, gen = 1024, torch.Generator().manual_seed(17)
    cpu = build_fftree_native("secp256k1", n, device="cpu")
    x, h = _limbs(gen, 2, n), _limbs(gen, 2, n // 2)
    g, a, c = _limbs(gen, 2, 16), _limbs(gen, 16), _limbs(gen, 16)
    calls = [("extend", (h, 0)), ("extend", (h, 1)), ("mextend", (h, 0)),
             ("mextend", (h, 1)), ("degree", (cpu.enter(x),)),
             ("redc_z0", (x,)), ("redc_z1", (x,)), ("modular_reduce", (x,)),
             ("vanish", (h,)), ("redc_z0", (g, a)), ("redc_z1", (g, a)),
             ("modular_reduce", (g, a, c))]
    want = [getattr(cpu, m)(*args) for m, args in calls]
    for ex in ("scan", "unrolled"):
        if ex == "unrolled":
            monkeypatch.setenv("ECFFT_EXECUTOR", "unrolled")
        gpu = build_fftree_native("secp256k1", n, device=card)
        before = step.mulss.launches["fold16"]
        for (m, args), w in zip(calls, want):
            got = getattr(gpu, m)(*(t.to(card) if isinstance(t, torch.Tensor)
                                    else t for t in args))
            assert torch.equal(got.cpu(), w), (ex, m)
        assert step.mulss.launches["fold16"] > before


# (form, TW, half or halves, kinds): pair levels one and two tiles apart,
# and cascades of mixed kinds (16 levels, a launch's most, among them),
# at the production tile and at TW = 8. A
# pair-level block holds the smallest power of two of lanes >= B, up to
# its own size: B = 200 leaves its last lane group ragged, B = 256 none
FUSED = [("bf1", 128, 128, None), ("bf1", 128, 256, None),
         ("bf2", 128, 128, None), ("bf2", 128, 256, None),
         ("bf1", 8, 16, None), ("bf2", 8, 8, None),
         ("cascade", 128, (64, 1, 64), (0, 0, 1)),
         ("cascade", 128, (32, 16, 8, 4, 2, 1), (0, 0, 0, 0, 0, 0)),
         ("cascade", 8, (4, 1, 2), (1, 0, 1)),
         ("cascade", 128, (64, 32, 16, 8, 4, 2, 1) * 2 + (32, 1),
          (0,) * 7 + (1,) + (0,) * 6 + (1, 0))]


@pytest.mark.parametrize("B", [1, 5, 64, 200, 256])
@pytest.mark.parametrize("form,tw,half,kinds", FUSED)
def test_fused_kernel_matches_plain_version(card, monkeypatch, form, tw,
                                            half, kinds, B):
    monkeypatch.setattr(unrolled, "TW", tw)
    gen = torch.Generator().manual_seed(tw + B)
    if form == "cascade":
        A, start = 4 * tw, 2 * tw
        cw = _limbs(gen, len(half), A)
        aw = _limbs(gen, max(sum(kinds), 1), A)
        args = (cw, aw, start, half, kinds)
    else:
        A, start = 4 * half, 4 * half
        coeffs = [_limbs(gen, A) for _ in range(1 if form == "bf1" else 2)]
        args = (*coeffs, start, half)
    state = _limbs(gen, start + A + tw, B).permute(0, 2, 1).contiguous()
    wrapper = getattr(unrolled, f"fused_{form}")
    want = state.clone()
    wrapper(SPEC, want, *args)
    got = state.to(card)
    before = wrapper.launches["fold16"]
    wrapper(SPEC, got, *(a.to(card) if isinstance(a, torch.Tensor) else a
                         for a in args))
    torch.cuda.synchronize()
    assert wrapper.launches["fold16"] == before + 1
    assert torch.equal(got.cpu(), want)
    assert not torch.equal(want, state)


@pytest.mark.parametrize("runs", ["whole", "split"])
def test_unrolled_enter_exit_on_card_match_cpu(card, monkeypatch, runs):
    """n = 1024 emits every fused form at TW = 128; "split" caps the
    levels per cascade launch at 4."""
    n, gen = 1024, torch.Generator().manual_seed(9)
    coeffs = _limbs(gen, 2, n)
    cpu = build_fftree_native("secp256k1", n, device="cpu")
    want = cpu.enter(coeffs)
    monkeypatch.setenv("ECFFT_EXECUTOR", "unrolled")
    gpu = build_fftree_native("secp256k1", n, device=card).prepare()
    max_levels = 4 if runs == "split" else unrolled.MAX_LEVELS

    def run(alg, batch):
        s, bank, meta = gpu._schedule(alg, n)
        return unrolled.run_unrolled(SPEC, gpu._pool, s, bank, batch, 2 * n,
                                     n, meta, max_levels)

    counts = [w.launches["fold16"] for w in (*unrolled.FUSED_WRAPPERS,
                                             *step.STEP_WRAPPERS[3:5])]
    evals = run("enter", coeffs.to(card))
    assert torch.equal(evals.cpu(), want)
    assert torch.equal(run("exit", evals).cpu(), coeffs)
    assert torch.equal(gpu.enter(coeffs.to(card)), evals)
    after = [w.launches["fold16"] for w in (*unrolled.FUSED_WRAPPERS,
                                            *step.STEP_WRAPPERS[3:5])]
    assert all(a > b for a, b in zip(after, counts)), (counts, after)


@pytest.mark.parametrize("B", [1, 5])
def test_word_kernels_on_a_prime_with_slack(card, B):
    """aff1s, the pair levels and the cascade (32-bit words) for 2^255 −
    19 against their plain versions, on random values and with every
    window value and coefficient p − 1."""
    spec = spec_for_prime(2**255 - 19)
    gen = torch.Generator().manual_seed(11 + B)

    def limbs(*shape):
        x = torch.randint(0, 1 << 16, (*shape, L), generator=gen,
                          dtype=torch.int32)
        x[..., -1] = torch.randint(0, 1 << 15, shape, generator=gen,
                                   dtype=torch.int32)
        return x

    top = torch.tensor(spec.to_limbs(spec.p - 1), dtype=torch.int32)
    W, A, start = 512, 256, 128
    pair_start = 256  # a pair level's window starts at a multiple of 2·half
    for fill in (False, True):
        state = limbs(W, B).permute(0, 2, 1).contiguous()
        x2 = limbs(A, B).permute(0, 2, 1).contiguous()
        c, cw, aw = limbs(A), limbs(3, A), limbs(1, A)
        if fill:
            for t in (state[start:], x2):
                t.copy_(top[:, None].expand_as(t))
            for t in (c, cw, aw):
                t.copy_(top.expand_as(t))
        for form in ("aff1s", "bf1", "bf2", "cascade"):
            want, got = state.clone(), state.to(card)
            if form == "aff1s":
                step.aff1s_ip(spec, c, want, x2, start)
                step.aff1s_ip(spec, c.to(card), got, x2.to(card), start)
            elif form == "bf1":
                unrolled.fused_bf1(spec, want, c, pair_start, 128)
                unrolled.fused_bf1(spec, got, c.to(card), pair_start, 128)
            elif form == "bf2":
                unrolled.fused_bf2(spec, want, aw[0], c, pair_start, 128)
                unrolled.fused_bf2(spec, got, aw[0].to(card), c.to(card),
                                   pair_start, 128)
            else:
                args = (start, (64, 1, 16), (0, 1, 0))
                unrolled.fused_cascade(spec, want, cw, aw, *args)
                unrolled.fused_cascade(spec, got, cw.to(card), aw.to(card),
                                       *args)
            torch.cuda.synchronize()
            assert torch.equal(got.cpu(), want), form


def test_unported_field_raises_on_card(card):
    """The STARK prime (no fold) runs on the card in the CIOS form, as the
    CPU computes it; a prime of one 16-bit limb without a fold is
    refused."""
    spec = spec_for_prime(
        0x0800000000000011000000000000000000000000000000000000000000000001)
    gen = torch.Generator().manual_seed(3)
    x = _general(spec, gen, 8, 3).permute(0, 2, 1).contiguous()
    c = _general(spec, gen, 8)
    want = torch.zeros_like(x)
    step.aff1s_ip(spec, c, want, x, 0)
    got = torch.zeros_like(x, device=card)
    step.aff1s_ip(spec, c.to(card), got, x.to(card), 0)
    assert torch.equal(got.cpu(), want)
    small = spec_for_prime(40961)
    z = torch.zeros((8, 1, 1), dtype=torch.int32, device=card)
    with pytest.raises(NotImplementedError, match="one 16-bit limb"):
        step.aff1s_ip(small, z[..., 0], z.clone(), z, 0)


# ------------------------------------------------------------------ M31

M31 = FIELDS["m31"]
M31_EDGE = [0, 1, M31.p - 1, M31.p - 2, 1 << 30, (M31.p - 1) // 2, 1 << 16]


def _m31(gen, *shape):
    """Canonical M31 values as (..., 1) int32, the edge values first."""
    x = torch.randint(0, M31.p, (*shape, 1), generator=gen,
                      dtype=torch.int32)
    flat = x.view(-1)
    flat[:len(M31_EDGE)] = torch.tensor(M31_EDGE, dtype=torch.int32)
    return x


def _m31_call(form, gen, B):
    """(wrapper, arguments, index of the state among them) of one M31 form
    on a random state whose window rows start at a tile boundary."""
    return _call(form, lambda *shape: _m31(gen, *shape), B)


def _call(form, draw, B):
    """(wrapper, arguments, index of the state among them) of one kernel
    form on values ``draw(*shape)`` ((*shape, L) int32): a random state
    whose window rows start at a tile boundary."""
    if form.startswith("fused"):
        A, start, W = 512, 512, 1152
    else:
        A, start, W = 200, 264, 520
    state = draw(W, B).permute(0, 2, 1).contiguous()
    x1, x2 = (draw(B, A).permute(1, 2, 0).contiguous() for _ in range(2))
    a, c = draw(A), draw(A)
    calls = {
        "aff1s_ip": (step.aff1s_ip, (c, state, x2, start), 1),
        "aff1g_ip": (step.aff1g_ip, (c, state, x1, x2, start), 1),
        "aff2g_ip": (step.aff2g_ip, (a, c, state, x1, x2, start), 2),
        "muladd1": (step.muladd1, (c, x1, x2, state, start), 3),
        "muladd2": (step.muladd2, (a, c, x1, x2, state, start), 4),
        "mulss": (step.mulss, (x1, x2, state, start), 2),
        "fused_bf1": (unrolled.fused_bf1, (state, c, start, 128), 0),
        "fused_bf2": (unrolled.fused_bf2, (state, a, c, start, 256), 0),
        "fused_cascade": (unrolled.fused_cascade, (
            state, torch.stack([draw(A) for _ in range(3)]),
            a.unsqueeze(0), start, (64, 1, 2), (0, 1, 0)), 0),
    }
    return calls[form]


@pytest.mark.parametrize("B", [1, 5, 256])
@pytest.mark.parametrize("form", ["aff1s_ip", "aff1g_ip", "aff2g_ip",
                                  "muladd1", "muladd2", "mulss", "fused_bf1",
                                  "fused_bf2", "fused_cascade"])
def test_m31_kernel_matches_plain_version(card, form, B):
    """Each M31 form against its plain version: the edge values in the
    first rows, rows outside the window untouched, one launch of the M31
    form counted and none of the 16-limb one."""
    wrapper, args, si = _m31_call(form, torch.Generator().manual_seed(B), B)
    want = [a.clone() if isinstance(a, torch.Tensor) else a for a in args]
    wrapper(M31, *want)
    got = [a.to(card) if isinstance(a, torch.Tensor) else a for a in args]
    before = dict(wrapper.launches)
    wrapper(M31, *got)
    torch.cuda.synchronize()
    assert dict(wrapper.launches) == {**before,
                                      "m31": before.get("m31", 0) + 1}
    assert torch.equal(got[si].cpu(), want[si])
    assert not torch.equal(want[si], args[si])


def test_m31_mulss_squares_one_buffer(card):
    gen = torch.Generator().manual_seed(2)
    x = _m31(gen, 64, 3).permute(0, 2, 1).contiguous()
    state = torch.zeros((96, 1, 3), dtype=torch.int32)
    want = state.clone()
    step.mulss(M31, x, x, want, 16)
    got, xc = state.to(card), x.to(card)
    step.mulss(M31, xc, xc, got, 16)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("ex", ["scan", "unrolled"])
def test_m31_enter_exit_on_card_match_native(card, monkeypatch, ex):
    """n = 1024 emits every fused form at TW = 128."""
    if ex == "unrolled":
        monkeypatch.setenv("ECFFT_EXECUTOR", "unrolled")
    n, gen = 1024, torch.Generator().manual_seed(21)
    coeffs = _m31(gen, 3, n)
    gpu = build_fftree_native("m31", n, device=card)
    nt = NativeFFTree("m31", n)
    before = [w.launches["m31"] for w in (*step.STEP_WRAPPERS,
                                          *unrolled.FUSED_WRAPPERS)]
    evals = gpu.enter(coeffs.to(card))
    for b in range(3):
        assert list(gpu.decode(evals[b])) == nt.enter(
            [int(v) for v in coeffs[b, :, 0]])
    assert torch.equal(gpu.exit(evals).cpu(), coeffs)
    after = [w.launches["m31"] for w in (*step.STEP_WRAPPERS,
                                         *unrolled.FUSED_WRAPPERS)]
    assert sum(after) > sum(before)


def test_m31_algorithms_on_card_match_cpu(card, monkeypatch):
    """The seven other methods over M31 on the card, on each executor,
    against the CPU's plain versions at n = 1024 (the general modulus at
    m = 16)."""
    n, gen = 1024, torch.Generator().manual_seed(23)
    cpu = build_fftree_native("m31", n, device="cpu")
    x, h = _m31(gen, 2, n), _m31(gen, 2, n // 2)
    g, a, c = _m31(gen, 2, 16), _m31(gen, 16), _m31(gen, 16)
    a[a == 0] = 1  # no zero entry to invert
    calls = [("extend", (h, 0)), ("extend", (h, 1)), ("mextend", (h, 0)),
             ("mextend", (h, 1)), ("degree", (cpu.enter(x),)),
             ("redc_z0", (x,)), ("redc_z1", (x,)), ("modular_reduce", (x,)),
             ("vanish", (h,)), ("redc_z0", (g, a)), ("redc_z1", (g, a)),
             ("modular_reduce", (g, a, c))]
    want = [getattr(cpu, m)(*args) for m, args in calls]
    for ex in ("scan", "unrolled"):
        if ex == "unrolled":
            monkeypatch.setenv("ECFFT_EXECUTOR", "unrolled")
        gpu = build_fftree_native("m31", n, device=card)
        before = step.mulss.launches["m31"]
        for (m, args), w in zip(calls, want):
            got = getattr(gpu, m)(*(t.to(card) if isinstance(t, torch.Tensor)
                                    else t for t in args))
            assert torch.equal(got.cpu(), w), (ex, m)
        assert step.mulss.launches["m31"] > before


# ---------------------------------------------------- the general prime

# a prime of each new form: the CIOS form at 16 limbs (the STARK prime, and
# a 256-bit prime with slack 0), at 3 and 13 limbs (odd: a 16-bit last
# round); the fold form at 16 limbs with its digit past 2^10, and at 4
GENERAL = [spec_for_prime(p, name) for name, p in (
    ("stark",
     0x0800000000000011000000000000000000000000000000000000000000000001),
    ("cios256",
     0xaacdabbb49c9c6072c54a01283037cadfde8ec5e3e1544596ebbec4cc598e9c7),
    ("cios3", 0xff8000000f),
    ("cios13", 0xd9cd502d42af1ffe0de8d79f49af6d114c4a6f188a424e61cb),
    ("band", (1 << 256) - 1053), ("m61", (1 << 61) - 1),
    # one 16-bit limb with a fold ("fold1"): slack 9, F = 61; slack 0,
    # F = 1023
    ("fold1_97", 97), ("fold1_64513", 64513))]


def _general(spec, gen, *shape):
    """Canonical values as (*shape, L) int32: random limbs with a top limb
    below p's, the edge values 0, 1, p − 1, p − 2, R mod p and (p − 1)/2
    first."""
    L = spec.num_limbs
    x = torch.randint(0, 1 << 16, (*shape, L), generator=gen,
                      dtype=torch.int32)
    x[..., -1] = torch.randint(0, spec.to_limbs(spec.p)[-1], shape,
                               generator=gen, dtype=torch.int32)
    p = spec.p
    edge = fd.encode(spec, [0, 1, p - 1, p - 2, spec.r % p, (p - 1) // 2])
    flat = x.view(-1, L)
    k = min(edge.shape[0], flat.shape[0])
    flat[:k] = edge[:k]
    return x


@pytest.mark.parametrize("B", [1, 5, 256])
@pytest.mark.parametrize("form", ["aff1s_ip", "aff1g_ip", "aff2g_ip",
                                  "muladd1", "muladd2", "mulss", "fused_bf1",
                                  "fused_bf2", "fused_cascade"])
@pytest.mark.parametrize("spec", GENERAL, ids=lambda s: s.name)
def test_general_form_matches_plain_version(card, spec, form, B):
    """Each kernel of each new form against its plain version: the edge
    values in the first rows, rows outside the window untouched, one
    launch counted, in the field's form."""
    gen = torch.Generator().manual_seed(B)
    wrapper, args, si = _call(form, lambda *sh: _general(spec, gen, *sh), B)
    want = [a.clone() if isinstance(a, torch.Tensor) else a for a in args]
    wrapper(spec, *want)
    got = [a.to(card) if isinstance(a, torch.Tensor) else a for a in args]
    key = step.kernel_form(spec)
    before = wrapper.launches[key]
    wrapper(spec, *got)
    torch.cuda.synchronize()
    assert wrapper.launches[key] == before + 1
    assert torch.equal(got[si].cpu(), want[si])
    assert not torch.equal(want[si], args[si])


@pytest.mark.parametrize("name", list(CURVES))
def test_general_algorithms_on_card_match_cpu(card, monkeypatch, name):
    """The eight algorithms over each general field on the card, on each
    executor (the unrolled one at TW = 8, where n = 64 emits every fused
    form), against the CPU's plain versions at n = 64 (the general
    modulus at m = 16); the field's form launches."""
    register()
    n, gen = 64, torch.Generator().manual_seed(29)
    cpu = build_fftree_native(name, n, device="cpu")
    spec = cpu.spec
    x, h = _general(spec, gen, 2, n), _general(spec, gen, 2, n // 2)
    g, a, c = (_general(spec, gen, 2, 16), _general(spec, gen, 16),
               _general(spec, gen, 16))
    a[(a == 0).all(-1)] = fd.encode(spec, 1)  # no zero entry to invert
    calls = [("enter", (x,)), ("exit", (x,)), ("extend", (h, 0)),
             ("mextend", (h, 1)), ("degree", (cpu.enter(x),)),
             ("redc_z0", (x,)), ("redc_z1", (x,)), ("modular_reduce", (x,)),
             ("vanish", (h,)), ("redc_z0", (g, a)),
             ("modular_reduce", (g, a, c))]
    want = [getattr(cpu, m)(*args) for m, args in calls]
    for ex in ("scan", "unrolled"):
        if ex == "unrolled":
            monkeypatch.setenv("ECFFT_EXECUTOR", "unrolled")
            monkeypatch.setattr(unrolled, "TW", 8)
        gpu = build_fftree_native(name, n, device=card)
        before = [w.launches[FORMS[name]] for w in (*step.STEP_WRAPPERS,
                                                    *unrolled.FUSED_WRAPPERS)]
        for (m, args), w in zip(calls, want):
            got = getattr(gpu, m)(*(t.to(card) if isinstance(t, torch.Tensor)
                                    else t for t in args))
            assert torch.equal(got.cpu(), w), (ex, m)
        after = [w.launches[FORMS[name]] for w in (*step.STEP_WRAPPERS,
                                                   *unrolled.FUSED_WRAPPERS)]
        assert sum(after) > sum(before) and after[5] > before[5], ex


# the warp cascade (csrc/warp_cascade.cuh) of each form it takes: M31's,
# and the word forms of one and two words: M61 ("fold4"), the CIOS primes
# of 3 and 2 limbs, and a 2-limb fold prime
FEW = [M31] + [spec_for_prime(p, name) for name, p in (
    ("m61", (1 << 61) - 1), ("cios3", 0xff8000000f),
    ("cios2", 3 * (1 << 30) + 1), ("fold2", (1 << 32) - 5),
    ("fold1", 64513))]


@pytest.mark.parametrize("B", [1, 5, 64, 200, 256])
@pytest.mark.parametrize("tw,halves,kinds",
                         [c[1:] for c in FUSED if c[0] == "cascade"])
@pytest.mark.parametrize("spec", FEW, ids=lambda s: s.name)
def test_warp_cascade_matches_plain_version(card, monkeypatch, spec, tw,
                                            halves, kinds, B):
    """The cascades of FUSED on each form of the warp design, against the
    plain version bit for bit, rows outside the window untouched: ragged
    lane groups (B = 1, 5, 200), A = 32 at TW = 8 (a chunk cut by the
    window's end), 16 levels."""
    monkeypatch.setattr(unrolled, "TW", tw)
    gen = torch.Generator().manual_seed(tw + B)
    draw = ((lambda *sh: _m31(gen, *sh)) if fd.is_m31(spec)
            else (lambda *sh: _general(spec, gen, *sh)))
    A, start = 4 * tw, 2 * tw
    cw, aw = draw(len(halves), A), draw(max(sum(kinds), 1), A)
    state = draw(start + A + tw, B).permute(0, 2, 1).contiguous()
    want = state.clone()
    unrolled.fused_cascade(spec, want, cw, aw, start, halves, kinds)
    got = state.to(card)
    key = step.kernel_form(spec)
    before = unrolled.fused_cascade.launches[key]
    unrolled.fused_cascade(spec, got, cw.to(card), aw.to(card), start,
                           halves, kinds)
    torch.cuda.synchronize()
    assert unrolled.fused_cascade.launches[key] == before + 1
    assert torch.equal(got.cpu(), want)
    assert not torch.equal(want, state)


# ------------------------------------------ the NTT and tree persistence


@pytest.mark.parametrize("ex", ["scan", "unrolled"])
@pytest.mark.parametrize("p,g,n", [(None, 3, 1024), (97, 5, 32),
                                   (64513, 5, 1024)],
                         ids=["stark", "p97", "p64513"])
def test_ntt_on_card_matches_cpu_and_naive(card, monkeypatch, ex, p, g, n):
    """ntt and intt on the card equal the CPU's plain versions on the
    whole batch and naive evaluation on two lanes; each stage is one
    launch of the 2-mul step of the prime's form ("cios16", "fold1")."""
    from ecfft_tpu_torch.ntt import STARK_P, NTTPlan
    from ecfft_tpu_torch.utils.poly import evaluate

    p = p or STARK_P
    if ex == "unrolled":
        monkeypatch.setenv("ECFFT_EXECUTOR", "unrolled")
    cpu = NTTPlan(n, p=p, generator=g, device="cpu")
    gpu = NTTPlan(n, p=p, generator=g, device=card)
    import random

    rng = random.Random(n)
    cs = [[rng.randrange(p) for _ in range(n)] for _ in range(3)]
    key = step.kernel_form(gpu.spec)
    wrapper = step.muladd2 if ex == "unrolled" else step.aff2g_ip
    before = wrapper.launches[key]
    ev = gpu.ntt(gpu.encode(cs))
    torch.cuda.synchronize()
    assert wrapper.launches[key] == before + n.bit_length() - 1
    assert torch.equal(ev.cpu(), cpu.ntt(cpu.encode(cs)))
    w = pow(g, (p - 1) // n, p)
    for b in (0, 2):
        assert list(gpu.decode(ev[b])) == [evaluate(cs[b], pow(w, i, p), p)
                                           for i in range(n)]
    assert [list(r) for r in gpu.decode(gpu.intt(ev))] == cs


def test_trees_and_plans_on_the_default_device_take_its_tensors(card):
    """A tree or an NTT plan made for "cuda" (no index, the default)
    takes the tensors its own ``encode`` makes, which lie on "cuda:0"."""
    from ecfft_tpu_torch.ntt import NTTPlan

    tree = build_fftree_native("secp256k1", 16)
    assert tree.device == torch.device("cuda")
    x = tree.encode([[3 * i + 1 for i in range(16)]])
    assert torch.equal(tree.exit(tree.enter(x)), x)
    plan = NTTPlan(16)
    y = plan.encode([[i for i in range(16)]])
    assert torch.equal(plan.intt(plan.ntt(y)), y)
    with pytest.raises(ValueError, match="int32 limbs on cuda"):
        tree.enter(x.cpu())


def test_place_on_card_matches_a_card_built_tree(card):
    n = 256
    gen = torch.Generator().manual_seed(5)
    x = _limbs(gen, 2, n)
    moved = build_fftree_native("secp256k1", n, device="cpu").prepare()
    moved.place_on(card)
    assert moved._pool.device.type == "cuda"
    built = build_fftree_native("secp256k1", n, device=card)
    assert torch.equal(moved.enter(x.to(card)), built.enter(x.to(card)))


def test_cached_and_deserialized_trees_on_card(card, tmp_path):
    from ecfft_tpu_torch.serialize import (deserialize_fftree,
                                           serialize_fftree)

    n = 256
    gen = torch.Generator().manual_seed(6)
    x = _limbs(gen, 2, n).to(card)
    first = build_fftree_native("secp256k1", n, device=card)
    first.prepare(cache_dir=str(tmp_path))
    second = build_fftree_native("secp256k1", n, device=card)
    second.prepare(cache_dir=str(tmp_path))
    want = first.enter(x)
    assert torch.equal(second.enter(x), want)
    for compress in (True, False):
        data = serialize_fftree(first, compress=compress)
        t2 = deserialize_fftree("secp256k1", data, compress=compress,
                                device=card)
        assert serialize_fftree(t2, compress=compress) == data
        assert torch.equal(t2.enter(x), want)



# ---------------- the device bootstrap, the unscheduled forms, sharding


def _launched():
    return {w.__name__: sum(w.launches.values()) for w in step.STEP_WRAPPERS}


@pytest.mark.parametrize("field,n", [("secp256k1", 32), ("m31", 256),
                                     ("gp_stark", 16)])
def test_bootstrap_on_card_matches_cpu(card, field, n):
    """``FFTree.build`` on the card: every table and mats plane equal to
    the CPU bootstrap's (held to the native engine there), its products
    launches of mulss, muladd1 and muladd2."""
    from ecfft_tpu_torch import FFTree

    register()
    before = _launched()
    got = FFTree.build(field, n, device=card)
    torch.cuda.synchronize()
    after = _launched()
    assert all(after[k] > before[k] for k in ("mulss", "muladd1",
                                               "muladd2"))
    want = FFTree.build(field, n, device="cpu")
    for m, t in want.tables.items():
        for name, v in t.items():
            if name == "mats":
                for gq, wq in zip(got.tables[m][name], v):
                    assert all(torch.equal(g, w) for g, w in zip(gq, wq))
            else:
                assert torch.equal(got.tables[m][name], v), (m, name)
    assert got.device == card
    assert got._dev_cache and all(
        e["s0"][0].device == card for k, e in got._dev_cache.items()
        if k[0] == "ext" and e["s0"][0].numel())


@pytest.mark.parametrize("case", list(UCASES))
@pytest.mark.parametrize("field", ["secp256k1", "m31", "gp_stark"])
def test_unscheduled_on_card_match_cpu(card, field, case):
    """Each ``*_unscheduled`` algorithm on the card (the fold form, M31
    and a CIOS form) equal to the CPU's, with kernel launches."""
    register()
    n = 16 if field == "gp_stark" else 64
    x, a, c = unscheduled_inputs(port_tree(field, n), case, 3, 12)
    call = UCASES[case][0]
    want = call(port_tree(field, n), *(torch.from_numpy(v.astype("int32"))
                                       for v in (x, a, c)))
    before = _launched()
    got = call(port_tree(field, n, card),
               *(torch.from_numpy(v.astype("int32")).to(card)
                 for v in (x, a, c)))
    torch.cuda.synchronize()
    assert sum(_launched().values()) > sum(before.values())
    assert got.device == card and torch.equal(got.cpu(), want)


def test_sharding_on_card_matches_unsharded(card):
    """A ShardedFFTree over two shards of one card: every algorithm (REDC
    and MOD also by tables) equal to the unsharded tree's, each shard on
    the card."""
    from ecfft_tpu_torch.parallel.sharding import ShardedFFTree, make_mesh
    from test_torch_sharding import ALGORITHMS

    n, batch = 32, 4
    tree = build_fftree_native("m31", n, device=card).prepare()
    stree = ShardedFFTree(tree, make_mesh(["cuda:0", "cuda:0"])).prepare()
    gen = torch.Generator().manual_seed(9)
    for alg, (call, points) in ALGORITHMS.items():
        x, a, c = (torch.randint(1, FIELDS["m31"].p, shape,
                                 generator=gen, dtype=torch.int32).to(card)
                   for shape in ((batch, points, 1), (n, 1), (n, 1)))
        got = call(stree, x, a, c)
        assert [o.device for o in got] == stree.mesh, alg
        assert torch.equal(torch.cat(got), call(tree, x, a, c)), alg


def test_m31_enter_unscheduled_past_the_folded_grid(card):
    """M31 ENTER unscheduled at n = 2^16, B = 512: with the blocks folded
    into the lanes its first level would launch 2^24 lanes, past the
    65,535 blocks of grid y of ``csrc/m31_kernels.cu``; the blocks lie on
    the rows instead. Lanes 0 and B − 1 against the native engine, the
    whole batch against EXIT's round trip."""
    n, batch = 1 << 16, 512
    tree = build_fftree_native("m31", n, device=card)
    gen = torch.Generator(device=card).manual_seed(13)
    x = torch.randint(0, FIELDS["m31"].p, (batch, n, 1), generator=gen,
                      device=card, dtype=torch.int32)
    evals = tree.enter_unscheduled(x)
    nt = NativeFFTree("m31", n)
    for b in (0, batch - 1):
        assert [int(v) for v in fd.decode(FIELDS["m31"], evals[b])] == \
            nt.enter([int(v) for v in fd.decode(FIELDS["m31"], x[b])])
    assert torch.equal(tree.exit_unscheduled(evals), x)


# ------------------------------------------- the step loops' CUDA graphs


def _counts():
    return {(w.__name__, form): n
            for w in (*step.STEP_WRAPPERS, *unrolled.FUSED_WRAPPERS)
            for form, n in w.launches.items()}


def _added(before):
    now = _counts()
    return {k: v - before.get(k, 0) for k, v in now.items()
            if v != before.get(k, 0)}


@pytest.mark.parametrize("ex", ["scan", "unrolled"])
@pytest.mark.parametrize("field,n", [("secp256k1", 256), ("m31", 1024),
                                     ("gp_cios3", 256)])
def test_replay_matches_eager_and_native(card, monkeypatch, ex, field, n):
    """ENTER and EXIT, B = 3: the first call (the eager loop and its
    capture), a replay on other inputs and a replay of the first inputs
    again equal the eager loop on the card, the CPU and the native
    engine; the same graph serves both inputs, and each replay adds the
    eager loop's launches to the counts."""
    from ecfft_tpu_torch.ops import graphs

    register()
    if ex == "unrolled":
        monkeypatch.setenv("ECFFT_EXECUTOR", "unrolled")
    spec = FIELDS[field]
    cpu = build_fftree_native(spec, n, device="cpu")
    gpu = build_fftree_native(spec, n, device=card)
    nt = NativeFFTree(spec, n)
    rng = __import__("random").Random(n)
    for alg in ("enter", "exit"):
        ins = [fd.encode(spec, [[rng.randrange(spec.p) for _ in range(n)]
                                for _ in range(3)], "cpu") for _ in range(2)]
        first = getattr(gpu, alg)(ins[0].to(card))
        (rec,) = [r for r in gpu._graphs.graphs.values()
                  if r.pins[0] is gpu._schedule(alg, n)[0]]
        with graphs._eager_loop():
            before = _counts()
            eager = [getattr(gpu, alg)(x.to(card)) for x in ins]
            eager_launches = _added(before)
        before = _counts()
        replayed = [getattr(gpu, alg)(x.to(card)) for x in (*ins, ins[0])]
        torch.cuda.synchronize()
        assert _added(before) == {k: 3 * v // 2
                                  for k, v in eager_launches.items()}
        assert rec.replays == 3 and len(gpu._graphs.graphs) == (
            1 if alg == "enter" else 2)
        assert torch.equal(first, eager[0])
        for got, want, x in zip(replayed, (*eager, eager[0]),
                                (*ins, ins[0])):
            assert torch.equal(got, want)
            assert torch.equal(got.cpu(), getattr(cpu, alg)(x))
        for b in range(3):
            assert [int(v) for v in fd.decode(spec, replayed[1][b])] == \
                getattr(nt, alg)([int(v) for v in fd.decode(spec,
                                                             ins[1][b])])
        ptrs = {t.untyped_storage().data_ptr() for t in replayed}
        assert len(ptrs) == 3
        assert rec.state.untyped_storage().data_ptr() not in ptrs


def test_replay_in_chunks_and_on_other_trees(card, monkeypatch):
    """ENTER over a card read as holding two lanes: chunks of 2 and 2,
    each a graph, replayed; a second tree and a sharded replica on the
    same card capture their own graphs and agree."""
    from ecfft_tpu_torch.parallel.sharding import ShardedFFTree, make_mesh

    n, B, gen = 256, 4, torch.Generator().manual_seed(31)
    coeffs = _limbs(gen, B, n)
    cpu = build_fftree_native("secp256k1", n, device="cpu")
    gpu = build_fftree_native("secp256k1", n, device=card).prepare()
    want = cpu.enter(coeffs)
    monkeypatch.setattr(schedule, "_lanes_per_chunk", lambda *a: 2)
    for _ in range(3):
        assert torch.equal(gpu.enter(coeffs.to(card)).cpu(), want)
    assert sorted(k[1] for k in gpu._graphs.graphs) == [2]
    (rec,) = gpu._graphs.graphs.values()
    assert rec.replays == 5  # two chunks a call, after the first's two
    monkeypatch.undo()
    other = build_fftree_native("secp256k1", n, device=card)
    stree = ShardedFFTree(other, make_mesh(["cuda:0", "cuda:0"]))
    for _ in range(2):
        assert torch.equal(other.enter(coeffs.to(card)).cpu(), want)
        assert torch.equal(torch.cat(stree.enter(coeffs)).cpu(), want)
    assert all(len(t._graphs.graphs) == 1 for t in (other, *stree.trees))


def test_batch_sizes_on_card_share_power_of_two_graphs(card):
    """ENTER at every B from 1 to 9 on one tree at n = 256, twice: five
    graphs (1, 2, 4, 8 and 16 lanes) serve the nine sizes, every call
    equal to the CPU's; their static states hold 31 lanes in all, under
    two states of 16, and the second round captures nothing."""
    n, gen = 256, torch.Generator().manual_seed(41)
    cpu = build_fftree_native("secp256k1", n, device="cpu")
    gpu = build_fftree_native("secp256k1", n, device=card)
    for _ in range(2):
        for B in range(1, 10):
            coeffs = _limbs(gen, B, n)
            assert torch.equal(gpu.enter(coeffs.to(card)).cpu(),
                               cpu.enter(coeffs)), B
    recs = gpu._graphs.graphs
    assert sorted(k[1] for k in recs) == [1, 2, 4, 8, 16]
    assert sum(r.replays for r in recs.values()) == 13
    states = {id(r.state): r.state for r in recs.values()}
    W = next(iter(states.values())).shape[0]
    assert sum(st.numel() * 4 for st in states.values()) == W * 16 * 4 * 31


def test_ntt_replays_on_card(card):
    from ecfft_tpu_torch.ntt import NTTPlan

    plan = NTTPlan(32, p=97, generator=5, device=card)
    cpu = NTTPlan(32, p=97, generator=5, device="cpu")
    gen = torch.Generator().manual_seed(5)
    for _ in range(3):
        x = torch.randint(0, 97, (4, 32, 1), generator=gen,
                          dtype=torch.int32)
        ev = plan.ntt(x.to(card))
        assert torch.equal(ev.cpu(), cpu.ntt(x))
        assert torch.equal(plan.intt(ev).cpu(), x)
    assert len(plan._graphs.graphs) == 2
    assert all(r.replays == 2 for r in plan._graphs.graphs.values())


def test_a_capture_that_fails_raises_naming_its_key(card):
    """A loop that reads a value back to the host cannot be captured: the
    warm-up runs, the capture raises GraphError naming the loop, and no
    graph is kept."""
    from ecfft_tpu_torch.ops import graphs

    sched = build_fftree_native("secp256k1", 16, device="cpu")._schedule(
        "enter", 16)[0]
    cache = graphs.GraphCache()
    key = (graphs.loop_key(("scan",), (sched,)), 2, card)
    state = torch.zeros((8, 1, 2), dtype=torch.int32, device=card)

    def body(s):
        s += 1
        if int(s.sum()) < 0:  # a readback: refused under capture
            s -= 1

    with pytest.raises(graphs.GraphError, match=r"capture of the scan step "
                                                r"loop .* at 2 lanes on "
                                                r"cuda:0 failed"):
        cache.run(key, state, body, (sched,))
    assert cache.graphs == {}
    torch.cuda.synchronize()
    assert int(state[0, 0, 0]) == 1  # the warm-up ran, the capture did not


@pytest.mark.parametrize("field", ["secp256k1", "m31"])
def test_a_planned_replay_equals_the_eager_loop(card, monkeypatch, field):
    """ENTER and EXIT at n = 2^10, B = 5 on the scan executor: the first
    call makes the schedule's step plan (span ``ecfft.plan``) before the
    warm-up and the capture, and runs the D-engine's one-lane launches
    there alone; the captured launch shapes are the graph's 8 lanes, none
    of one lane; a replay and the eager loop, both reading the kept plan,
    equal the first call bit for bit."""
    from ecfft_tpu_torch.ops import graphs
    from ecfft_tpu_torch.utils import profiling

    monkeypatch.delenv("ECFFT_EXECUTOR", raising=False)
    n, B = 1024, 5
    spec = FIELDS[field]
    gpu = build_fftree_native(spec, n, device=card)
    rng = __import__("random").Random(n)
    for alg in ("enter", "exit"):
        x = fd.encode(spec, [[rng.randrange(spec.p) for _ in range(n)]
                             for _ in range(B)], "cpu").to(card)
        before = {w: w.shapes.copy() for w in step.STEP_WRAPPERS}
        first = getattr(gpu, alg)(x)
        made = {k: c for w in step.STEP_WRAPPERS
                for k, c in (w.shapes - before[w]).items()}
        rec = profiling.recorded()[-1]
        spans = {name: (s, e) for name, _, s, e in rec.spans}
        assert spans["ecfft.plan"][1] <= spans["ecfft.warmup"][0] \
            <= spans["ecfft.capture"][0]
        (cap,) = [r for r in gpu._graphs.graphs.values()
                  if r.pins[0] is gpu._schedule(alg, n)[0]]
        shapes = [k for _, c in cap.shapes for k in c]
        assert shapes and {lanes for _, _, lanes in shapes} == {8}
        assert any(lanes == 1 for _, _, lanes in made)  # the D-engine's
        replayed = getattr(gpu, alg)(x)
        assert profiling.recorded()[-1].chunks[0].how == "replay"
        with graphs._eager_loop():
            eager = getattr(gpu, alg)(x)
        torch.cuda.synchronize()
        assert torch.equal(first, eager) and torch.equal(replayed, eager)
        assert all(c.plan for r in profiling.recorded()[-3:]
                   for c in r.chunks)
        assert cap.replays == 1
    assert len(gpu._graphs.plans) == 2


# ------------------------------------------------------- the pair form

PAIR_W, PAIR_A = 131200, 65536  # the main path's window at n = 2^16
PAIR_FIELDS = {"fold16": "secp256k1", "cios16": "bn254_fq"}


def _canonical(spec, gen, *shape):
    """Values below p as (*shape, L) int32 limbs, drawn on the card: random
    limbs under a top limb below p's."""
    x = torch.randint(0, 1 << 16, (*shape, spec.num_limbs), generator=gen,
                      dtype=torch.int32, device=gen.device)
    x[..., -1] = torch.randint(0, spec.to_limbs(spec.p)[-1], shape,
                               generator=gen, dtype=torch.int32,
                               device=gen.device)
    return x


@pytest.mark.parametrize("h", [1, 128, 32768])
@pytest.mark.parametrize("B", [1, 16, 256])
@pytest.mark.parametrize("form", list(PAIR_FIELDS))
def test_pair_kernels_match_plain_versions(card, form, B, h):
    """Both pair kernels on the main path's window (W 131200, A 65536 at
    W − A − 128) equal their plain versions (run on the card) bit for bit,
    every row reading its partner, and with an index row that names every
    third row's own; rows outside the window stay as they were; each
    launch counts once under its step and once under its pair wrapper."""
    spec = FIELDS[PAIR_FIELDS[form]]
    assert step.kernel_form(spec) == form
    gen = torch.Generator(device=card).manual_seed(B + h)
    start = PAIR_W - PAIR_A - 128
    state = _canonical(spec, gen, PAIR_W, B).permute(0, 2, 1).contiguous()
    q = torch.arange(PAIR_A, device=card)
    partners = (start + (q ^ h)).to(torch.int32)
    own = torch.where(q % 3 == 0, start + q, start + (q ^ h)).to(torch.int32)
    for kind, gathered in (("aff1s_pair_ip", step.aff1s_ip),
                           ("aff2g_pair_ip", step.aff2g_ip)):
        coeffs = [_canonical(spec, gen, PAIR_A)
                  for _ in range(1 + (kind == "aff2g_pair_ip"))]
        for x2 in (partners, own):
            want = state.clone()
            win = want[start:start + PAIR_A]
            x2w = step._pair_window(want, start, PAIR_A, h, x2)
            if len(coeffs) == 2:
                new = step._muladd2_cols(spec, coeffs[0].unsqueeze(-1), win,
                                         coeffs[1].unsqueeze(-1), x2w)
            else:
                new = step._muladd1_cols(spec, coeffs[0].unsqueeze(-1), win,
                                         x2w)
            want[start:start + PAIR_A] = new
            del new, x2w, win
            got = state.clone()
            wrapper = getattr(step, kind)
            before = (wrapper.launches[form], gathered.launches[form])
            wrapper(spec, *coeffs, got, h, start, x2)
            torch.cuda.synchronize()
            assert (wrapper.launches[form], gathered.launches[form]) == \
                (before[0] + 1, before[1] + 1)
            assert torch.equal(got, want), (kind, x2 is own)
            del got, want
            torch.cuda.empty_cache()


@pytest.mark.parametrize("field", ["secp256k1", "bn254_fq"])
def test_a_replay_with_pair_steps_equals_the_eager_loop(card, monkeypatch,
                                                        field):
    """ENTER and EXIT at n = 1024, B = 5, whose plans mark their pair
    steps: the first call (eager loop, then the capture), a replay and
    the eager loop equal one another bit for bit and the native engine
    (ENTER) or the input (EXIT of ENTER); the replay counts one pair launch
    a marked step, and its record's chunk notes them."""
    from ecfft_tpu_torch.ops import graphs
    from ecfft_tpu_torch.utils import profiling

    monkeypatch.delenv("ECFFT_EXECUTOR", raising=False)
    n, B = 1024, 5
    spec = FIELDS[field]
    form = step.kernel_form(spec)
    gpu = build_fftree_native(spec, n, device=card)
    nt = NativeFFTree(spec, n)
    rng = __import__("random").Random(n)
    ints = [[rng.randrange(spec.p) for _ in range(n)] for _ in range(B)]
    x = fd.encode(spec, ints, "cpu").to(card)
    outs = {}
    for alg in ("enter", "exit"):
        arg = x if alg == "enter" else outs["enter"]
        first = getattr(gpu, alg)(arg)
        (plan,) = [p for p in gpu._graphs.plans.values()
                   if p.pins[0] is gpu._schedule(alg, n)[0]]
        marked = sum(1 for h in plan.pairs if h)
        assert marked > 0
        before = [w.launches[form] for w in step.PAIR_WRAPPERS]
        replayed = getattr(gpu, alg)(arg)
        after = [w.launches[form] for w in step.PAIR_WRAPPERS]
        (chunk,) = profiling.recorded()[-1].chunks
        assert chunk.how == "replay"
        assert sum(after) - sum(before) == marked == \
            sum(k for _, c in chunk.pairs for k in c.values())
        with graphs._eager_loop():
            eager = getattr(gpu, alg)(arg)
        torch.cuda.synchronize()
        assert torch.equal(first, eager) and torch.equal(replayed, eager)
        outs[alg] = eager
    assert [[int(v) for v in fd.decode(spec, r)] for r in outs["enter"].cpu()] \
        == [nt.enter(v) for v in ints]
    assert torch.equal(outs["exit"], x)
