"""The capture cache of the step loops (``ecfft_tpu_torch/ops/graphs.py``)
on the CPU, with a stand-in for the CUDA graph.

The stand-in capture runs the loop's Python on a copy of the state (a
capture records launches and computes nothing), and the stand-in replay
runs the recorded loop on the state it was captured on (what a graph's
replay computes), so the cache's keys, its static states, the pack and
unpack around them, the launch counts and the errors run here as they
run on a card. The chunk plumbing through them is held against the
native engine (secp256k1, M31 and a prime with Montgomery residents, at
n = 64, B = 3, on both executors) and once against the JAX package's
scan executor, on the same numpy inputs. Tolerance: 0 differing limbs.
The card's own capture and replay are held in ``tests/test_torch_cuda.py``.
"""

import gc
import os
import sys
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecfft_tpu.native import build_fftree_native as build_jax_tree
from ecfft_tpu_torch import build_fftree_native
from ecfft_tpu_torch.fields import device as fd
from ecfft_tpu_torch.fields.registry import FIELDS
from ecfft_tpu_torch.native import NativeFFTree
from ecfft_tpu_torch.ops import graphs, step, unrolled
from ecfft_tpu_torch.ops import schedule as tsch
from ecfft_tpu_torch.parallel.sharding import make_mesh, replicate_tree

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_general_fields import register  # noqa: E402

N, B = 64, 3
register()
FIELD_NAMES = ("secp256k1", "m31", "gp_cios3")


class StandInGraph:
    """A captured loop: a replay runs it on the state it was captured on."""

    def __init__(self, body, state):
        self.body, self.state = body, state

    def replay(self):  # the loop's data, not its Python's counting
        before = graphs._counts_now()
        self.body(self.state)
        graphs._take_back(before)


class StandInPool:
    def __init__(self, device):
        self.handle = self.stream = None
        self.bytes = 0
        self.live = weakref.WeakSet()


@pytest.fixture
def card(monkeypatch):
    """The CPU standing in for a card: every step loop goes through the
    cache; returns the log of captures (device, state shape) and
    replays."""
    log = {"captures": [], "replays": 0}

    def capture(device, pool, body, state):
        log["captures"].append((device, tuple(state.shape)))
        body(state.clone())  # the loop's Python runs; no data changes
        return StandInGraph(body, state), 0.0, 0.0, 0

    def replay(device, graph):
        log["replays"] += 1
        graph.replay()

    monkeypatch.setattr(graphs, "replays", lambda t: not graphs._EAGER)
    monkeypatch.setattr(graphs, "_capture", capture)
    monkeypatch.setattr(graphs, "_replay", replay)
    monkeypatch.setattr(graphs, "_Pool", StandInPool)
    monkeypatch.setattr(graphs, "_POOLS", {})
    return log


@pytest.fixture
def executor(request, monkeypatch):
    if request.param == "unrolled":
        monkeypatch.setenv("ECFFT_EXECUTOR", "unrolled")
    else:
        monkeypatch.delenv("ECFFT_EXECUTOR", raising=False)
    return request.param


_NATIVE = {}


def native(name):
    if name not in _NATIVE:
        _NATIVE[name] = NativeFFTree(FIELDS[name], N)
    return _NATIVE[name]


def tree(name="secp256k1"):
    return build_fftree_native(FIELDS[name], N, device="cpu")


def values(name, seed, batch=B):
    """Canonical values of ``batch`` polys: numpy-seeded python ints."""
    rng = np.random.RandomState(seed)
    p = FIELDS[name].p
    return [[int.from_bytes(rng.bytes(40), "little") % p for _ in range(N)]
            for _ in range(batch)]


def encode(name, vals):
    return fd.encode(FIELDS[name], vals, "cpu")


def ints(name, t):
    return [[int(v) for v in fd.decode(FIELDS[name], row)] for row in t]


# --------------------------------------------------------------- the CPU


@pytest.mark.parametrize("executor", ["scan", "unrolled"], indirect=True)
def test_a_cpu_tensor_never_reaches_capture(executor, monkeypatch):
    """On the CPU the eager loop runs: nothing is captured, the tree's
    cache stays empty, and ENTER equals the native engine."""
    def refuse(*a):
        raise AssertionError("a CPU tensor reached capture")

    monkeypatch.setattr(graphs, "_capture", refuse)
    monkeypatch.setattr(graphs, "_replay", refuse)
    t, vals = tree(), values("secp256k1", 1)
    got = t.enter(encode("secp256k1", vals))
    assert ints("secp256k1", got) == [native("secp256k1").enter(v)
                                      for v in vals]
    assert t._graphs.graphs == {}
    assert not graphs._POOLS or all(not p.live
                                    for p in graphs._POOLS.values())


# ------------------------------------------- the chunk plumbing, replayed


@pytest.mark.parametrize("executor", ["scan", "unrolled"], indirect=True)
@pytest.mark.parametrize("alg", ["enter", "exit"])
@pytest.mark.parametrize("name", FIELD_NAMES)
def test_replay_matches_the_native_engine(card, executor, alg, name):
    """The first call (warm-up and capture) and a replay on other inputs
    equal the native engine on every lane; the replay runs the graph the
    first call captured."""
    t, nt = tree(name), native(name)
    for call, seed in enumerate((2, 3)):
        vals = values(name, seed)
        got = getattr(t, alg)(encode(name, vals))
        assert ints(name, got) == [getattr(nt, alg)(v) for v in vals], call
    assert len(card["captures"]) == 1 and card["replays"] == 1


@pytest.mark.parametrize("executor", ["scan", "unrolled"], indirect=True)
def test_chunks_replay_their_own_graphs(card, executor, monkeypatch):
    """A batch of 3 in chunks of 2 and 1: one graph for each lane count,
    each with a static state of its lanes; every call equals the engine."""
    monkeypatch.setattr(tsch, "_lanes_per_chunk", lambda *a: 2)
    t, nt = tree(), native("secp256k1")
    for seed in (4, 5):
        vals = values("secp256k1", seed)
        got = t.enter(encode("secp256k1", vals))
        assert ints("secp256k1", got) == [nt.enter(v) for v in vals]
    assert [s[2] for _, s in card["captures"]] == [2, 1]
    assert card["replays"] == 2
    assert sorted(r.state.shape[2] for r in t._graphs.graphs.values()) \
        == [1, 2]


def test_replay_matches_the_jax_scan_executor(card, monkeypatch):
    """secp256k1 ENTER at n = 64, B = 3 on the same numpy limbs: the
    first call and a replay equal the JAX package's scan executor."""
    monkeypatch.delenv("ECFFT_EXECUTOR", raising=False)
    jt = build_jax_tree("secp256k1", N)
    rng = np.random.RandomState(9)
    top = jt.spec.to_limbs(jt.spec.p)[-1]
    coeffs = rng.randint(0, 1 << 16, size=(B, N, 16)).astype(np.uint32)
    coeffs[..., -1] = rng.randint(0, top, size=(B, N))
    want = np.asarray(jt.enter(jnp.asarray(coeffs)))
    t = tree()
    x = torch.from_numpy(coeffs.astype(np.int32))
    for _ in range(2):
        got = t.enter(x)
        np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    assert len(card["captures"]) == 1 and card["replays"] == 1


# ------------------------------------------------------------- the keys


@pytest.mark.parametrize("change", ["schedule", "executor", "lanes"])
def test_a_new_key_captures_and_a_repeated_key_replays(card, monkeypatch,
                                                       change):
    """ENTER at B = 3 on the scan executor, then a call differing in one
    part of the key (EXIT's schedule, the unrolled executor, B = 2):
    each captures once, and the same calls again replay both."""
    monkeypatch.delenv("ECFFT_EXECUTOR", raising=False)
    t = tree()
    x = encode("secp256k1", values("secp256k1", 7))

    def other():
        if change == "schedule":
            return t.exit(x)
        if change == "lanes":
            return t.enter(x[:2])
        monkeypatch.setenv("ECFFT_EXECUTOR", "unrolled")
        try:
            return t.enter(x)
        finally:
            monkeypatch.delenv("ECFFT_EXECUTOR")

    first = [t.enter(x), other()]
    assert len(card["captures"]) == 2 and card["replays"] == 0
    again = [t.enter(x), other()]
    assert len(card["captures"]) == 2 and card["replays"] == 2
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    assert len(t._graphs.graphs) == 2


def test_a_new_device_captures_anew(card):
    """Keys that differ in the device alone are two graphs: a replica on
    another card captures on its own."""
    cache, calls = graphs.GraphCache(), []
    sched = tree()._schedule("enter", N)[0]
    loop = graphs.loop_key(("scan",), (sched,))
    for device in ("cuda:0", "cuda:1", "cuda:0", "cuda:1"):
        key = (loop, 2, torch.device(device))
        cache.run(key, cache.graphs[key].state if key in cache.graphs
                  else torch.zeros(4, 1, 2, dtype=torch.int32),
                  lambda s: calls.append(s.data_ptr()), (sched,))
    assert len(cache.graphs) == 2 and card["replays"] == 2
    assert len(card["captures"]) == 2


def test_place_on_and_replicas_start_their_own_graphs(card):
    """Each replica of a sharded tree, and a tree moved by place_on, has
    a cache of its own (its pool and banks are its own)."""
    t = tree()
    t.enter(encode("secp256k1", values("secp256k1", 8)))
    assert len(t._graphs.graphs) == 1
    reps = replicate_tree(t, make_mesh(["cpu", "cpu"]))
    caches = {id(t._graphs), *(id(r._graphs) for r in reps)}
    assert len(caches) == 3
    assert all(r._graphs.graphs == {} for r in reps)
    t.place_on("cpu")
    assert t._graphs.graphs == {}


def test_a_batch_keeps_its_first_chunking(card, monkeypatch):
    """A later call of a batch size takes the chunking of its first call,
    whatever the budget reads then, and so replays the graphs it
    captured."""
    lanes = iter([2, 1])
    monkeypatch.setattr(tsch, "_lanes_per_chunk", lambda *a: next(lanes))
    t = tree()
    x = encode("secp256k1", values("secp256k1", 10))
    a, b = t.enter(x), t.enter(x)
    assert torch.equal(a, b)
    assert [s[2] for _, s in card["captures"]] == [2, 1]
    assert card["replays"] == 2


def test_the_eager_loop_bypasses_the_graphs(card):
    """The private entry runs the eager loop on the card: no capture, no
    replay, the same bits."""
    t = tree()
    x = encode("secp256k1", values("secp256k1", 11))
    with graphs._eager_loop():
        eager = t.enter(x)
    assert card["captures"] == [] and t._graphs.graphs == {}
    assert torch.equal(t.enter(x), eager)
    assert len(card["captures"]) == 1


def test_batch_sizes_share_power_of_two_graphs(card):
    """ENTER at every batch size from 1 to 8 on one tree: the chunks pad
    to 1, 2, 4 and 8 lanes, so four graphs serve the eight sizes, and
    their static states hold 15 lanes in all (under two states of 8).
    Every call, the padded ones among them, equals the native engine,
    and a second round replays without a capture."""
    t, nt = tree(), native("secp256k1")
    for rnd in range(2):
        for batch in range(1, 9):
            vals = values("secp256k1", 40 + batch, batch)
            got = t.enter(encode("secp256k1", vals))
            assert ints("secp256k1", got) == [nt.enter(v) for v in vals], \
                (rnd, batch)
        assert len(card["captures"]) == 4
    assert card["replays"] == 12
    assert sorted(k[1] for k in t._graphs.graphs) == [1, 2, 4, 8]
    states = {id(r.state): r.state for r in t._graphs.graphs.values()}
    W = next(iter(states.values())).shape[0]
    held = sum(st.numel() * 4 for st in states.values())
    assert held == W * 16 * 4 * 15 < 2 * W * 16 * 4 * 8


def test_no_cache_runs_the_eager_loop(card):
    """run_schedule without a cache on a tensor that replays: the eager
    loop, no capture (no graph would outlive the call)."""
    t, nt = tree(), native("secp256k1")
    sched, bank, _ = t._schedule("enter", N)
    vals = values("secp256k1", 52)
    got = tsch.run_schedule(t.spec, t._pool, sched, bank,
                            encode("secp256k1", vals), 2 * N, N)
    assert ints("secp256k1", got) == [nt.enter(v) for v in vals]
    assert card["captures"] == [] and card["replays"] == 0


# ---------------------------------------------------- state and outputs


def test_outputs_are_fresh_tensors(card):
    """Each call returns a tensor of its own: a later call on other
    inputs leaves an earlier output as it was, and no output shares the
    graph's static state."""
    t = tree()
    x1 = encode("secp256k1", values("secp256k1", 12))
    x2 = encode("secp256k1", values("secp256k1", 13))
    out1 = t.enter(x1)
    kept = out1.clone()
    out2 = t.enter(x2)
    out3 = t.enter(x1)
    assert torch.equal(out1, kept) and torch.equal(out3, kept)
    assert not torch.equal(out1, out2)
    (rec,) = t._graphs.graphs.values()
    owned = {rec.state.untyped_storage().data_ptr()}
    ptrs = [o.untyped_storage().data_ptr() for o in (out1, out2, out3)]
    assert len(set(ptrs)) == 3 and not owned & set(ptrs)


def test_static_states_are_shared_by_shape_and_freed_with_the_graphs(card):
    """ENTER and EXIT (one W) at B = 3 share one static state of 4 lanes
    (the power of two above 3); B = 2 has its own; both go when the
    tree's graphs go."""
    t = tree()
    x = encode("secp256k1", values("secp256k1", 14))
    t.exit(t.enter(x))
    t.enter(x[:2])
    recs = list(t._graphs.graphs.values())
    assert len(recs) == 3
    by_lanes = {}
    for r in recs:
        by_lanes.setdefault(r.state.shape[2], set()).add(id(r.state))
    assert {k: len(v) for k, v in by_lanes.items()} == {4: 1, 2: 1}
    W = recs[0].state.shape[0]
    keys = [(W, 16, lanes, torch.device("cpu")) for lanes in (4, 2)]
    assert all(k in graphs._STATES for k in keys)
    del t, recs, r
    gc.collect()
    assert not any(k in graphs._STATES for k in keys)


# ------------------------------------------------------------ the counts


def test_launch_counts_are_added_once_per_replay(card):
    """The warm-up's launches count, the capture's are taken back, and
    each replay adds the captured launches again."""
    cache = graphs.GraphCache()
    sched = tree()._schedule("enter", N)[0]
    key = (graphs.loop_key(("scan",), (sched,)), 2, torch.device("cpu"))
    state = torch.zeros(4, 1, 2, dtype=torch.int32)
    w1, w2 = step.aff1s_ip.launches, unrolled.fused_cascade.launches
    base = (w1["fold16"], w2["m31"])

    def body(s):
        s += 1
        w1["fold16"] += 2
        w2["m31"] += 1

    cache.run(key, state, body, (sched,))
    assert (w1["fold16"] - base[0], w2["m31"] - base[1]) == (2, 1)
    assert int(state[0, 0, 0]) == 1  # the warm-up's answer, kept
    for k in range(1, 4):
        cache.run(key, state, body, (sched,))
        assert (w1["fold16"] - base[0], w2["m31"] - base[1]) == \
            (2 + 2 * k, 1 + k)
        assert int(state[0, 0, 0]) == 1 + k
    rec = cache.graphs[key]
    assert {(w.__name__, f): n for w, c in rec.counts
            for f, n in c.items()} == {("aff1s_ip", "fold16"): 2,
                                       ("fused_cascade", "m31"): 1}
    assert rec.replays == 3


# ------------------------------------------------------------ the errors


def test_a_failed_capture_raises_naming_the_key(card, monkeypatch):
    """A capture that fails raises GraphError naming the loop, its lanes
    and its device, keeps no graph, and never runs the eager loop in
    its place at a later call."""
    def broken(*a):
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")

    monkeypatch.setattr(graphs, "_capture", broken)
    monkeypatch.delenv("ECFFT_EXECUTOR", raising=False)
    t = tree()
    x = encode("secp256k1", values("secp256k1", 15))
    for _ in range(2):
        with pytest.raises(graphs.GraphError,
                           match=r"capture of the scan step loop .* at 4 "
                                 r"lanes on cpu failed: operation not"):
            t.enter(x)
    assert t._graphs.graphs == {}


def test_a_failed_replay_raises_naming_the_key(card, monkeypatch):
    t = tree()
    x = encode("secp256k1", values("secp256k1", 16))
    t.enter(x)

    def broken(device, graph):
        raise RuntimeError("graph launch failed")

    monkeypatch.setattr(graphs, "_replay", broken)
    with pytest.raises(graphs.GraphError,
                       match=r"replay of the scan step loop .* failed: "
                             r"graph launch failed"):
        t.enter(x)


# ------------------------------------------------------------ the budget


def test_the_chunk_budget_counts_the_graph_pool(monkeypatch):
    """With 6 GB free at the main path's ENTER shapes the batch runs
    whole; with 3 GB of it held by the graphs' pool it runs in chunks
    that fit the other 3."""
    sched = type("S", (), dict(W=131200, A=65536, bs_max=32768))
    L, Bm, m = 16, 256, 1 << 16
    dev = torch.device("cuda", 0)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (6 * 10**9, 80 << 30))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda device=None: 0)
    monkeypatch.setattr(torch.cuda, "memory_allocated",
                        lambda device=None: 0)
    assert tsch._lanes_per_chunk(sched, L, Bm, m, dev) == Bm
    monkeypatch.setattr(graphs, "pool_bytes", lambda device: 3 * 10**9)
    per_lane, fixed = tsch._chunk_bytes(sched, L, Bm, m)
    lanes = tsch._lanes_per_chunk(sched, L, Bm, m, dev)
    assert 1 <= lanes < Bm
    assert fixed + lanes * per_lane <= 3 * 10**9


def test_the_pool_of_the_current_card_answers_to_cuda(monkeypatch):
    """A device named "cuda" without an index is the current card: its
    pool's bytes are the same as under "cuda:0"."""
    pool = StandInPool(None)
    pool.bytes = 123
    live = graphs.GraphCache()  # a live graph's record stands in
    pool.live.add(live)
    monkeypatch.setattr(graphs, "_POOLS", {torch.device("cuda", 0): pool})
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert graphs.pool_bytes(torch.device("cuda")) == 123
    assert graphs.pool_bytes("cuda:0") == 123
    assert graphs.pool_bytes(torch.device("cuda", 1)) == 0
