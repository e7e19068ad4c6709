"""The port's CUDA step kernels on the card, against their plain PyTorch
versions (the same wrappers on CPU copies of the inputs), bit for bit.

Marked ``cuda``: without a card every test here skips. This file imports
no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py
"""

import os

import pytest
import torch

from ecfft_tpu_torch import build_fftree_native
from ecfft_tpu_torch.fields.registry import FIELDS, spec_for_prime
from ecfft_tpu_torch.ops import _build, schedule, step

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
    before = wrapper.launches
    wrapper(SPEC, *got, start)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    si = 2 if kind == "aff2g_ip" else 1  # the state's place in args
    assert torch.equal(got[si].cpu(), want[si])


def test_enter_exit_on_card_match_cpu(card):
    n, gen = 256, torch.Generator().manual_seed(3)
    coeffs = _limbs(gen, 4, n)
    cpu = build_fftree_native("secp256k1", n)
    gpu = build_fftree_native("secp256k1", n, device=card)
    evals = gpu.enter(coeffs.to(card))
    assert torch.equal(evals.cpu(), cpu.enter(coeffs))
    assert torch.equal(gpu.exit(evals).cpu(), coeffs)


def test_enter_chunks_the_batch_when_the_card_is_short(card, monkeypatch):
    """With the card's free memory read as two lanes' worth, ENTER runs
    a batch of 4 in two chunks of 2 and still equals the CPU's."""
    n, B, gen = 256, 4, torch.Generator().manual_seed(5)
    coeffs = _limbs(gen, B, n)
    cpu = build_fftree_native("secp256k1", n)
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
    """Where ninja is missing the kernels are built by nvcc directly; the
    library it makes runs the same kernels."""
    from torch.utils import cpp_extension

    monkeypatch.setattr(cpp_extension, "is_ninja_available", lambda: False)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(step, "_lib", None)
    _kernel_against_plain(card, "aff2g_ip", 3)
    assert os.path.dirname(step._lib._name) == str(tmp_path)


def test_unported_field_raises_on_card(card):
    spec = spec_for_prime(
        0x0800000000000011000000000000000000000000000000000000000000000001)
    z = torch.zeros((8, spec.num_limbs, 1), dtype=torch.int32, device=card)
    c = torch.zeros((8, spec.num_limbs), dtype=torch.int32, device=card)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        step.aff1s_ip(spec, c, z.clone(), z, 0)
