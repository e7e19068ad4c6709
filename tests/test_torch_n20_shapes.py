"""The executor's chunk budget at the shapes of the main path at n = 2^20
(the port's bench at secp256k1, B = 8 and 64, and M31, B = 128), on the
CPU with the card's memory patched: an 80 GB card holding the 2^20 tree's
pool and the input batch runs each batch whole, in one chunk, within the
budget. At secp256k1, B = 64 that one state holds more than 2^31
elements."""

import types

import pytest
import torch

from ecfft_tpu_torch import build_fftree_native
from ecfft_tpu_torch.ops import schedule as tsch

N = 1 << 20
# ENTER's schedule at n = 2^20: W = 2n + 1 rounded up to 128 rows, the
# window A = n, the D-engine's n/2 rows
SCHED = types.SimpleNamespace(W=2 * N + 128, A=N, bs_max=N // 2)
CARD = 80 * 10**9


def pool_rows(n: int) -> int:
    """Rows of ``build_pool``'s pool of a size-n tree, by its layout: the
    two constant rows, six rows per half of each compact matrix plane,
    each size's seven tables and fused vectors, the negated 2-leaf
    domain."""
    sizes = [1 << i for i in range(1, n.bit_length())]
    rows = 2 + sum(4 * 6 * (k >> (d + 2))
                   for k in sizes if k >= 4
                   for d in range(k.bit_length() - 2))
    for k in sizes:
        rows += 3 * k + 4 * (k // 2)                   # the seven tables
        rows += 4 * (k // 2) + k + 2 * (k // 2) + 1    # the fused vectors
    return rows + 2


@pytest.mark.parametrize("n", [16, 256])
def test_pool_rows_count_the_pool(n):
    tree = build_fftree_native("secp256k1", n, device="cpu")
    assert tree.pool_offsets["neg_leaf2"] + 2 == pool_rows(n)
    assert tree._pool.shape[0] == pool_rows(n)


def test_the_2_20_shapes():
    assert SCHED.W == 2_097_280
    assert pool_rows(N) * 16 * 4 == 2_818_540_416  # secp256k1's pool bytes
    assert SCHED.W * 16 * 64 > 2**31  # the B = 64 state's elements


@pytest.mark.parametrize("L", [16, 1])
@pytest.mark.parametrize("B", [8, 64, 128])
def test_chunk_budget_at_2_20(monkeypatch, L, B):
    """With the pool and the (B, n, L) input resident on an 80 GB card,
    the batch runs whole and its state, windows, output and step
    temporaries fit in what is free."""
    resident = (pool_rows(N) + B * N) * L * 4
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (CARD - resident, CARD))
    monkeypatch.setattr(torch.cuda, "memory_reserved",
                        lambda device=None: resident)
    monkeypatch.setattr(torch.cuda, "memory_allocated",
                        lambda device=None: resident)
    per_lane, fixed = tsch._chunk_bytes(SCHED, L, B, N)
    lanes = tsch._lanes_per_chunk(SCHED, L, B, N, torch.device("cuda", 0))
    assert lanes == B
    assert fixed + B * per_lane <= CARD - resident
    # the state and the two gathered windows, per lane
    assert per_lane == (SCHED.W + 2 * N) * L * 4
