"""The host side of the multi-tensor optimizer kernels (CPU): the launch
planner, the rows of a stacked count, the table layouts against the CUDA
source, the checks on ``meta`` tensors, and the routing of a tree that
is not on CUDA to the plain path.  The kernels themselves are held to
the plain path on the card (``test_torch_optimizers_cuda.py``)."""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from dist_keras_tpu_torch.ops import multi_tensor as mt
from dist_keras_tpu_torch.ops import optimizers as opt
from dist_keras_tpu_torch.utils.pytree import (
    tree_leaves,
    tree_map,
    tree_paths,
)

SOURCE = Path(mt.__file__).resolve().parent.parent / "csrc" / "multi_tensor.cu"
VIT_SIZES = [768 * 768, 196 * 768] + [768, 768, 768 * 768, 768 * 768,
                                      768 * 768, 768 * 768, 768, 768,
                                      768 * 3072, 3072, 3072 * 768, 768] * 12 \
    + [768, 768, 768 * 1000, 1000]


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, device="meta", dtype=dtype)


def test_the_vit_b16_tree_is_one_launch_with_a_block_prefix():
    assert len(VIT_SIZES) == 150 and sum(VIT_SIZES) == 86_528_488
    (launch,) = mt.plan_launches(VIT_SIZES, mt.ADAM_MAX_LEAVES)
    blocks = [math.ceil(n / mt.CHUNK) for n in VIT_SIZES]
    assert launch.leaves == list(range(150))
    assert launch.first_block == list(np.cumsum([0] + blocks[:-1]))
    assert launch.blocks == sum(blocks) == 21_180


@pytest.mark.parametrize("sizes,max_leaves,want", [
    ([5, 0, 4097, 1], 8, [([0, 2, 3], [0, 1, 3], 4)]),
    ([4096] * 5, 2, [([0, 1], [0, 1], 2), ([2, 3], [0, 1], 2),
                     ([4], [0], 1)]),
    ([0, 0], 4, []),
    ([1] * 700, mt.ADAM_MAX_LEAVES, [(list(range(0, 300)), list(range(300)), 300),
                                     (list(range(300, 600)), list(range(300)), 300),
                                     (list(range(600, 700)), list(range(100)), 100)]),
])
def test_plan_splits_at_the_table_size(sizes, max_leaves, want):
    got = mt.plan_launches(sizes, max_leaves)
    assert [(lc.leaves, lc.first_block, lc.blocks) for lc in got] == want


def test_a_strided_input_reaches_the_kernel_as_a_dense_copy():
    """Autograd hands some gradients over transposed (a TP block's w1,
    a conv kernel): the kernels get a dense copy, the rest as they
    are."""
    w = torch.arange(12.0).reshape(3, 4)
    deep = torch.arange(2.0 ** 9).reshape([2] * 9).transpose(0, 8)
    flat = torch.ones(5)
    got = mt._dense([w.t(), deep, flat])
    assert all(t.is_contiguous() for t in got)
    assert torch.equal(got[0], w.t()) and torch.equal(got[1], deep)
    assert got[2] is flat
    assert mt.plan_launches([10] * 3, 2, chunk=4) == [
        mt.Launch([0, 1], [0, 3], 6), mt.Launch([2], [0], 3)]


def test_row_lengths_of_a_stacked_count():
    assert mt.row_lengths([(3, 3), (7,)], ()) == [0, 0]
    assert mt.row_lengths([(4, 3, 3, 1, 32), (4,), (4, 10)], (4,)) == [
        288, 1, 10]
    assert mt.row_lengths([(2, 3, 5)], (2, 3)) == [5]


def test_table_rows_match_the_cuda_source():
    src = SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr [\w ]+ {name} = (\d+)", src).group(1))

    assert const("CHUNK") == mt.CHUNK
    assert const("ADAM_MAX_LEAVES") == mt.ADAM_MAX_LEAVES
    assert const("APPLY_MAX_LEAVES") == mt.APPLY_MAX_LEAVES
    sizes = {m.group(1): int(m.group(2)) for m in re.finditer(
        r"sizeof\((\w+)\) == (\d+)", src)}
    assert sizes == {"AdamLeaf": mt.ADAM_LEAF.itemsize,
                     "ApplyLeaf": mt.APPLY_LEAF.itemsize}
    # every table fits a launch's 32 KB of parameters
    assert 8 + mt.ADAM_MAX_LEAVES * mt.ADAM_LEAF.itemsize + 128 <= 32764
    assert 8 + mt.APPLY_MAX_LEAVES * mt.APPLY_LEAF.itemsize + 128 <= 32764
    # the kernels' names stay out of the benchmark's product and
    # attention patterns
    for name in re.findall(r"__global__ void(?: __launch_bounds__\(\w+\))?\s+(\w+)",
                           src):
        assert not re.search(r"flash_|gemm|gemv|cutlass|nvjet|xmma|cublas|"
                             r"splitk", name, re.I), name


def test_leaf_path_names_the_leaf():
    tree = {"w": 0, "blocks": [{"a": 1, "b": 2}, {"a": 3}]}
    assert [mt.leaf_path(tree, i) for i in range(4)] == [
        "['w']", "['blocks'][0]['a']", "['blocks'][0]['b']",
        "['blocks'][1]['a']"]
    assert len(tree_paths(tree)) == len(tree_leaves(tree))
    assert mt.leaf_path(7, 0) == "<root>"


@pytest.mark.parametrize("tree", [
    7,
    (1, [2, {"z": 3, "a": (4,)}]),
    {"b": [], "a": {"x": (5, 6)}, "c": 7},
])
def test_tree_paths_follow_tree_leaves(tree):
    """Each path indexes its leaf, in :func:`tree_leaves` order."""
    paths = tree_paths(tree)
    assert len(paths) == len(tree_leaves(tree))
    for path, leaf in zip(paths, tree_leaves(tree)):
        assert eval("tree" + path) == leaf


def test_trees_pair_their_dicts_by_key():
    a = {"x": 1, "y": [2, 3]}
    b = {"y": [20, 30], "x": 10}
    assert mt._zip_leaves("t", a, b) == [(1, 10), (2, 20), (3, 30)]
    with pytest.raises(ValueError, match="differ in structure"):
        mt._zip_leaves("t", a, {"x": 1})


def test_checks_take_what_the_kernels_take():
    g = {"w": _meta(4, 3), "b": [_meta(4), _meta(4, 3, 3, 1, 8)]}
    leaves = mt.check_adam(g, g, g, _meta())
    assert len(leaves) == 3
    assert all(x is g["w"] for x in leaves[0]) and len(leaves[0]) == 3
    # a transposed gradient is taken
    t = {"w": _meta(3, 4).t(), "b": [_meta(4), _meta(4, 3, 3, 1, 8)]}
    assert mt.check_adam(t, g, g, _meta())[0][0] is t["w"]
    # bf16 leaves of four stacked workers
    bf = tree_map(lambda x: x.to(torch.bfloat16), g)
    assert len(mt.check_adam(bf, bf, bf, _meta(4), bf)) == 3
    leaves = mt.check_apply(g, t)
    assert leaves[0] == (g["w"], t["w"])
    # the apply takes p and u of either dtype
    assert len(mt.check_apply(g, bf)) == 3


@pytest.mark.parametrize("what,mutate,err,match", [
    ("f16", lambda g: {**g, "w": g["w"].half()}, TypeError, r"\['w'\]"),
    ("f64", lambda g: {**g, "w": g["w"].double()}, TypeError, r"\['w'\]"),
    ("int", lambda g: {**g, "w": g["w"].int()}, TypeError, r"\['w'\]"),
    ("mixed", lambda g: {**g, "b": g["b"].to(torch.bfloat16)}, TypeError,
     r"\['b'\]"),
    ("shape", lambda g: {**g, "b": _meta(4, 2)}, ValueError,
     r"\['b'\].*shapes"),
    ("structure", lambda g: {**g, "c": _meta(3)}, ValueError, "structure"),
])
def test_adam_check_names_the_leaf_it_refuses(what, mutate, err, match):
    g = {"w": _meta(4, 3), "b": _meta(4, 3)}
    with pytest.raises(err, match=match):
        mt.check_adam(mutate(g), g, g, _meta())


def test_checks_refuse_a_count_that_does_not_lead():
    g = {"w": _meta(4, 3), "b": _meta(5, 3)}
    with pytest.raises(ValueError, match=r"\['b'\].*count's shape \(4,\)"):
        mt.check_adam(g, g, g, _meta(4))
    with pytest.raises(TypeError, match=r"\['w'\]"):
        mt.check_apply({"w": _meta(3, dtype=torch.float16)}, {"w": _meta(3)})
    with pytest.raises(ValueError, match=r"\['w'\].*shape"):
        mt.check_apply({"w": _meta(3)}, {"w": _meta(1, 3)})


def test_a_cpu_tree_takes_the_plain_path():
    rng = np.random.default_rng(0)
    params = {"w": torch.from_numpy(rng.standard_normal((4, 3), np.float32)),
              "b": [torch.from_numpy(rng.standard_normal(3, np.float32))]}
    counts = (mt.adam_update_launches, mt.apply_updates_launches)
    tx, ref = opt.adam(1e-3), opt.adam_reference(1e-3)
    pk, sk = params, tx.init(params)
    pr, sr = params, ref.init(params)
    for _ in range(3):
        g = tree_map(lambda t: torch.from_numpy(
            rng.standard_normal(t.shape, np.float32)), params)
        uk, sk = tx.update(g, sk, pk)
        ur, sr = ref.update(g, sr, pr)
        pk = opt.apply_updates(pk, uk)
        pr = opt.apply_updates_reference(pr, ur)
        for a, b in zip(tree_leaves((uk, sk, pk)), tree_leaves((ur, sr, pr))):
            assert torch.equal(a, b)
    assert counts == (mt.adam_update_launches, mt.apply_updates_launches)


def test_a_meta_tree_takes_the_plain_path():
    params = {"w": _meta(4, 3)}
    tx = opt.adam(1e-3)
    upd, state = tx.update(params, tx.init(params), params)
    assert upd["w"].device.type == "meta" and state["mu"]["w"].shape == (4, 3)
    assert opt.apply_updates(params, upd)["w"].device.type == "meta"
