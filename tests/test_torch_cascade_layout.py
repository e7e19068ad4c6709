"""csrc/warp_cascade.cuh, the layout of the cascade of few words (M31 and
the word forms of one and two words), compiled with g++ on the CPU (the
very header nvcc compiles for the card) into a small ctypes harness in
``ecfft_tpu_torch/_build/``.

The harness runs a launch as the card would: the grid of
``wc::grid``/``wc::place`` block by block, each block's coefficient rows
staged by ``wc::stage``, then each warp with lanes: its 32 lanes' tiles
loaded by ``Tile::load`` (16-byte groups or single lanes, the ragged
lane group and a chunk past the window's end guarded), the levels run
by ``Tile::level`` with the warp's shuffles emulated (a lane reads lane
t ^ m's words as they stood before the level, after the harness checks
that the word it hands over is its own), and ``Tile::store``. The result
is held bit for bit against ``ops/unrolled.py::_cascade_plain`` on seeded
numpy inputs: M31, M61 ("fold4"), a CIOS prime of 3 limbs and one of 2
(one word), and 64513 ("fold1", one 16-bit limb), at tiles of 2, 8 and 128 rows, 1 to 12 lanes (and 72: a
block with idle warps), 1, 14 and 16 levels of mixed kinds. Also: which
rows a lane holds and how a xor splits into lane and register bits, the
grid's cover of every (chunk, lane group), and the launch checks. Needs
g++ only; imports no JAX."""

import ctypes
import os

import numpy as np
import pytest
import torch

from ecfft_tpu_torch.fields import device as fd
from ecfft_tpu_torch.fields.registry import FIELDS, spec_for_prime
from ecfft_tpu_torch.ops import _build, step, unrolled
from ecfft_tpu_torch.ops.unrolled import MAX_LEVELS

HEADER = os.path.join(os.path.dirname(_build.KERNEL_SOURCES[0]),
                      "warp_cascade.cuh")
HARNESS = r"""
#include <vector>
#include "warp_cascade.cuh"

// a warp's shuffle on the CPU: lane t receives lane t ^ m's word as it
// stood before the level; the word lane t hands over must be its own
template <class AR, int V>
struct Emulated {
  const wc::Tile<AR, V>* before;
  int t;
  int* bad;
  uint32_t operator()(uint32_t value, int j, int v, int w, int m) const {
    if (before[t].x[j][v][w] != value) ++*bad;
    return before[t ^ m].x[j][v][w];
  }
};

// one launch, block by block and warp by warp; returns the number of
// words handed to a shuffle that were not the lane's own
template <class AR>
int run(const typename AR::Consts& fd, const Levels& lv, const int32_t* cw,
        const int32_t* aw, int32_t* state, int start, int A, int B,
        bool vec) {
  constexpr int V = wc::lanes(AR::NW), NW = AR::NW;
  const wc::Grid g = wc::grid(A, B, V);
  std::vector<uint32_t> sh(wc::slots(lv) * NW * wc::CHUNK);
  int bad = 0;
  for (int blk = 0; blk < g.chunks * g.per_chunk; ++blk) {
    int q0, b0;
    wc::place(g, blk, 0, V, q0, b0);
    for (int i = 0; i < wc::slots(lv) * wc::CHUNK; ++i)
      wc::stage<AR>(i, lv.k, cw, aw, q0, A, sh.data());
    for (int w = 0; w < g.warps; ++w) {
      wc::place(g, blk, w, V, q0, b0);
      if (b0 >= B) continue;
      const int rows = A - q0 < wc::CHUNK ? A - q0 : wc::CHUNK;
      const int64_t row0 = static_cast<int64_t>(start) + q0;
      std::vector<wc::Tile<AR, V>> tiles(wc::WARP), before;
      for (int t = 0; t < wc::WARP; ++t)
        tiles[t].load(state, row0, t, rows, b0, B, vec);
      int ai = 0;
      for (int li = 0; li < lv.k; ++li) {
        const bool two = lv.kind[li] != 0;
        before = tiles;
        for (int t = 0; t < wc::WARP; ++t)
          tiles[t].level(fd, sh.data() + li * NW * wc::CHUNK,
                         sh.data() + (lv.k + ai) * NW * wc::CHUNK, t,
                         lv.half[li], two,
                         Emulated<AR, V>{before.data(), t, &bad});
        ai += two;
      }
      for (int t = 0; t < wc::WARP; ++t)
        tiles[t].store(state, row0, t, rows, b0, B, vec);
    }
  }
  return bad;
}

extern "C" {
// form 0: M31; 1: 4 limbs, fold; 2: 3 limbs, CIOS; 3: 2 limbs, CIOS;
// 4: one 16-bit limb, fold.
// -1 where the launcher refuses the levels
int h_cascade(int form, const Field* fd, const Levels* lv, const int32_t* cw,
              const int32_t* aw, int32_t* state, int start, int tw, int A,
              int B, int vec) {
  if (!wc::levels_ok(*lv, tw) || A <= 0 || A % tw || B <= 0) return -1;
  switch (form) {
    case 0: return run<wc::M31Arith>({}, *lv, cw, aw, state, start, A, B,
                                     vec);
    case 1: return run<wc::WordArith<4, false>>(*fd, *lv, cw, aw, state,
                                                start, A, B, vec);
    case 2: return run<wc::WordArith<3, true>>(*fd, *lv, cw, aw, state,
                                               start, A, B, vec);
    case 3: return run<wc::WordArith<2, true>>(*fd, *lv, cw, aw, state,
                                               start, A, B, vec);
    case 4: return run<wc::WordArith<1, false>>(*fd, *lv, cw, aw, state,
                                                start, A, B, vec);
  }
  return -2;
}
// the grid of a launch and the place of warp w of block blk: out = chunks,
// groups, warps, per_chunk, q0, b0
void h_grid(int A, int B, int V, int blk, int w, int* out) {
  const wc::Grid g = wc::grid(A, B, V);
  out[0] = g.chunks, out[1] = g.groups, out[2] = g.warps;
  out[3] = g.per_chunk;
  wc::place(g, blk, w, V, out[4], out[5]);
}
int h_row(int t, int j) { return wc::row(t, j); }
int h_lane_xor(int h) { return wc::lane_xor(h); }
int h_reg_xor(int h) { return wc::reg_xor(h); }
int h_lanes(int nw) { return wc::lanes(nw); }
int h_shared_bytes(const Levels* lv, int nw) {
  return wc::shared_bytes(*lv, nw);
}
}
"""

M31 = FIELDS["m31"]
# name: (harness form, field)
FORMS = {"m31": (0, M31), "fold4": (1, spec_for_prime((1 << 61) - 1)),
         "cios3": (2, spec_for_prime(0xff8000000f)),
         "cios2": (3, spec_for_prime(3 * (1 << 30) + 1)),
         "fold1": (4, spec_for_prime(64513))}
# tw: (window start, window rows A, state rows W): A not a multiple of 128
# where the tile allows, so the last chunk is cut by the window's end
SHAPES = {2: (2, 130, 136), 8: (8, 200, 216), 128: (0, 128, 256)}


@pytest.fixture(scope="module")
def lib():
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    src = os.path.join(_build.BUILD_DIR, "cascade_layout_harness.cpp")
    out = os.path.join(_build.BUILD_DIR, "libcascade_layout_harness.so")
    if not os.path.exists(src) or open(src).read() != HARNESS:
        with open(src, "w") as f:
            f.write(HARNESS)
    if _build._stale(out, [src, *_build.KERNEL_HEADERS]):
        _build._compile(lambda o: [
            "g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-I",
            os.path.dirname(HEADER), "-o", o, src], out)
    so = ctypes.CDLL(out)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    so.h_cascade.argtypes = [i32] + [ptr] * 5 + [i32] * 5
    so.h_grid.argtypes = [i32] * 5 + [ptr]
    so.h_shared_bytes.argtypes = [ptr, i32]
    return so


def _levels(halves, kinds):
    return unrolled._Levels(len(halves),
                            (ctypes.c_int * MAX_LEVELS)(*halves),
                            (ctypes.c_int * MAX_LEVELS)(*kinds))


def _values(spec, rng, shape):
    """Canonical values as (*shape, L) int32: p − 1, p − 2, 0, 1 first,
    then random ones (M31: below p; else random limbs with a top limb
    below p's)."""
    L = spec.num_limbs
    if fd.is_m31(spec):
        x = rng.integers(0, spec.p, (*shape, 1), dtype=np.int64)
    else:
        x = rng.integers(0, 1 << 16, (*shape, L), dtype=np.int64)
        x[..., -1] = rng.integers(0, spec.to_limbs(spec.p)[-1], shape)
    edge = fd.encode(spec, [spec.p - 1, spec.p - 2, 0, 1]).numpy()
    flat = x.reshape(-1, L)
    flat[:min(4, len(flat))] = edge[:min(4, len(flat))]
    return x.astype(np.int32)


def _run(lib, form, halves, kinds, cw, aw, state, start, tw, vec):
    """The harness's launch on ``state`` (a numpy array, in place)."""
    code, spec = FORMS[form]
    fld = None if form == "m31" else ctypes.byref(step._field(spec))
    lv = _levels(halves, kinds)
    arrs = [np.ascontiguousarray(a) for a in (cw, aw)]
    return lib.h_cascade(code, fld, ctypes.byref(lv),
                         *(a.ctypes.data for a in arrs), state.ctypes.data,
                         start, tw, cw.shape[1], state.shape[2], int(vec))


def _case(form, tw, B, k, seed):
    """Seeded levels of mixed kinds (halves the tile takes, in ENTER's
    falling order, repeated), coefficient rows and a state."""
    _, spec = FORMS[form]
    rng = np.random.default_rng(seed)
    start, A, W = SHAPES[tw]
    hs = [h for h in (64, 32, 16, 8, 4, 2, 1) if h < tw and tw % (2 * h) == 0]
    halves = [hs[i % len(hs)] for i in range(k)]
    kinds = [int(v) for v in rng.integers(0, 2, k)]
    if k > 1:
        kinds[0], kinds[-1] = 0, 1
    n2 = sum(kinds)
    cw = _values(spec, rng, (k, A))
    aw = _values(spec, rng, (max(n2, 1), A))
    state = _values(spec, rng, (W, B)).transpose(0, 2, 1).copy()
    return spec, halves, kinds, cw, aw, state, start


@pytest.mark.parametrize("k", [1, 14, 16])
@pytest.mark.parametrize("B", [1, 3, 4, 5, 8, 12, 72])
@pytest.mark.parametrize("tw", [2, 8, 128])
@pytest.mark.parametrize("form", list(FORMS))
def test_warp_levels_match_the_plain_cascade(lib, form, tw, B, k):
    spec, halves, kinds, cw, aw, state, start = _case(
        form, tw, B, k, 1000 * tw + 10 * B + k)
    want = torch.from_numpy(state.copy())
    unrolled._cascade_plain(spec, want, torch.from_numpy(cw),
                            torch.from_numpy(aw), start, halves, kinds)
    got = state.copy()
    assert _run(lib, form, halves, kinds, cw, aw, got, start, tw,
                B % 4 == 0) == 0
    assert np.array_equal(got, want.numpy())
    assert not np.array_equal(got, state)


@pytest.mark.parametrize("form", list(FORMS))
def test_scalar_and_vector_lanes_agree(lib, form):
    """At B = 8 the launcher takes 16-byte groups; the single-lane path
    gives the same bits."""
    spec, halves, kinds, cw, aw, state, start = _case(form, 128, 8, 14, 5)
    a, b = state.copy(), state.copy()
    assert _run(lib, form, halves, kinds, cw, aw, a, start, 128, True) == 0
    assert _run(lib, form, halves, kinds, cw, aw, b, start, 128, False) == 0
    assert np.array_equal(a, b)


def test_a_level_splits_into_lane_and_register_bits(lib):
    """Lane t holds rows t + 32 j; the partner row r ^ h of every row r
    is row(t ^ lane_xor(h), j ^ reg_xor(h)), for every h < 128."""
    assert sorted(lib.h_row(t, j) for t in range(32) for j in range(4)) \
        == list(range(128))
    for h in range(1, 128):
        m, s = lib.h_lane_xor(h), lib.h_reg_xor(h)
        assert 0 <= m < 32 and 0 <= s < 4
        for t in range(32):
            for j in range(4):
                assert lib.h_row(t ^ m, j ^ s) == lib.h_row(t, j) ^ h
    assert [h for h in (1, 2, 4, 8, 16, 32, 64)
            if lib.h_reg_xor(h) == 0] == [1, 2, 4, 8, 16]


@pytest.mark.parametrize("A,B", [(128, 1), (200, 12), (65536, 72),
                                 (384, 2048)])
def test_grid_covers_each_chunk_and_lane_group_once(lib, A, B):
    """Every (chunk, lane group) lies in exactly one warp of one block; a
    warp past the last lane group (only in a chunk's last block) has no
    lanes; a block holds at most 8 warps."""
    for nw in (1, 2):
        V = lib.h_lanes(nw)
        out = (ctypes.c_int * 6)()
        lib.h_grid(A, B, V, 0, 0, out)
        chunks, groups, warps, per_chunk = out[:4]
        assert chunks == -(-A // 128) and groups == -(-B // V)
        assert 1 <= warps <= 8
        seen = []
        for blk in range(chunks * per_chunk):
            for w in range(warps):
                lib.h_grid(A, B, V, blk, w, out)
                q0, b0 = out[4], out[5]
                assert q0 % 128 == 0 and b0 % V == 0
                if b0 < B:
                    seen.append((q0, b0))
                else:
                    assert blk % per_chunk == per_chunk - 1
        assert sorted(seen) == [(128 * c, V * g) for c in range(chunks)
                                for g in range(groups)]


def test_launch_refuses_levels_outside_the_tile(lib):
    """h must lie in [1, tw) with tw % 2h == 0; 1 to 16 levels; tw from 2
    to 128 dividing A; B >= 1. The staged rows take (k + kind-1 levels)
    x 128 rows of NW words."""
    spec, halves, kinds, cw, aw, state, start = _case("m31", 8, 4, 3, 7)
    for bad_halves, tw in (([4, 8, 1], 8), ([4, 3, 1], 8), ([4, 0, 1], 8),
                           ([4, 2, 1], 256), ([1, 1, 1], 1)):
        assert _run(lib, "m31", bad_halves, kinds, cw, aw, state.copy(),
                    start, tw, True) == -1
    assert _run(lib, "m31", [], [], cw[:0], aw, state.copy(), start, 8,
                True) == -1
    assert _run(lib, "m31", halves, kinds, cw, aw, state.copy(), start, 8,
                True) == 0
    lv = _levels([64, 1, 2], [1, 0, 1])
    assert lib.h_shared_bytes(ctypes.byref(lv), 2) == 5 * 2 * 128 * 4
