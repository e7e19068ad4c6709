"""Batch sharding in the port (``ecfft_tpu_torch.parallel.sharding``) on
the CPU: a ``ShardedFFTree`` over ``["cpu", "cpu"]`` and ``["cpu"] * 4``
runs the eight algorithms (REDC and MOD also by tables given at run
time) with outputs equal, bit for bit, to the unsharded tree's, each
shard on its device and contiguous, no gather; sharded outputs feed the
next sharded call; the replicas leave the source tree where it was; an
uneven batch is refused naming both sizes; ``make_mesh()`` without a
card raises."""

import random

import pytest
import torch

from ecfft_tpu_torch.fftree import S0, S1, build_fftree_native
from ecfft_tpu_torch.parallel.sharding import (ShardedFFTree, make_mesh,
                                               replicate_tree, shard_batch)

N, B = 32, 4
_TREES = {}

# name: the call on a tree (or a sharded tree), its batch's points
ALGORITHMS = {
    "enter": (lambda t, x, a, c: t.enter(x), N),
    "exit": (lambda t, x, a, c: t.exit(x), N),
    "extend_s0": (lambda t, x, a, c: t.extend(x, S0), N // 2),
    "extend_s1": (lambda t, x, a, c: t.extend(x, S1), N // 2),
    "mextend_s1": (lambda t, x, a, c: t.mextend(x, S1), N // 2),
    "degree": (lambda t, x, a, c: t.degree(x), N),
    "redc_z0": (lambda t, x, a, c: t.redc_z0(x), N),
    "redc_z1": (lambda t, x, a, c: t.redc_z1(x), N),
    "mod": (lambda t, x, a, c: t.modular_reduce(x), N),
    "vanish": (lambda t, x, a, c: t.vanish(x), N // 2),
    "redc_z0_by_a": (lambda t, x, a, c: t.redc_z0(x, a), N),
    "mod_by_a": (lambda t, x, a, c: t.modular_reduce(x, a, c), N),
}
MESHES = {"two": ["cpu", "cpu"], "four": ["cpu"] * 4}


def _tree():
    if not _TREES:
        _TREES["m31"] = build_fftree_native("m31", N, device="cpu")
    return _TREES["m31"]


def _inputs(tree, points, seed):
    rng = random.Random(seed)
    p = tree.spec.p
    x = tree.encode([[rng.randrange(p) for _ in range(points)]
                     for _ in range(B)])
    a = tree.encode([rng.randrange(1, p) for _ in range(N)])
    c = tree.encode([rng.randrange(p) for _ in range(N)])
    return x, a, c


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("alg", list(ALGORITHMS))
def test_sharded_algorithms_match_the_unsharded_tree(mesh, alg):
    tree = _tree()
    call, points = ALGORITHMS[alg]
    x, a, c = _inputs(tree, points, list(ALGORITHMS).index(alg))
    want = call(tree, x, a, c)
    stree = ShardedFFTree(tree, make_mesh(MESHES[mesh])).prepare()
    got = call(stree, x, a, c)
    assert isinstance(got, list) and len(got) == len(MESHES[mesh])
    for shard, device in zip(got, stree.mesh):
        assert shard.device == device and shard.is_contiguous()
        assert shard.shape[0] == B // len(MESHES[mesh])
    assert torch.equal(torch.cat(got), want)


def test_sharded_outputs_compose_and_decode():
    tree = _tree()
    stree = ShardedFFTree(tree, make_mesh(["cpu", "cpu"]))
    x, _, _ = _inputs(tree, N, 7)
    evals = stree.enter(x)
    assert torch.equal(torch.cat(stree.exit(evals)), x)
    assert (stree.decode(evals) == tree.decode(tree.enter(x))).all()


def test_replicas_are_trees_of_their_own():
    tree = build_fftree_native("m31", 16, device="cpu").prepare()
    replicas = replicate_tree(tree, make_mesh(["cpu", "cpu"]))
    assert replicas[0] is not replicas[1] and tree not in replicas
    assert replicas[0]._scheds is not replicas[1]._scheds
    assert all(r.tables is tree.tables and r.device == torch.device("cpu")
               for r in replicas)


def test_uneven_batches_and_missing_cards_are_refused():
    tree = _tree()
    stree = ShardedFFTree(tree, make_mesh(["cpu"] * 4))
    x, _, _ = _inputs(tree, N, 3)
    with pytest.raises(ValueError, match="a batch of 3 does not split "
                                         "evenly over 4 devices"):
        stree.enter(x[:3])
    with pytest.raises(ValueError, match="2 shards for 4 devices"):
        shard_batch(stree.mesh, [x, x])
    if torch.cuda.is_available():
        assert all(d.type == "cuda" for d in make_mesh())
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ShardedFFTree(tree)
        with pytest.raises(RuntimeError, match="names a CUDA device|"
                                               "CUDA device is named"):
            make_mesh(["cuda:0", "cuda:0"])
