"""The port's DBoW2 text loader against the reference loader's arrays.
Everything is exact: every level's packed centroids (same bits), validity,
child bases, word tables and idf weights; `transform` on 500 random
descriptors gives equal word ids, weights and levelsup nodes; the native
scanner (compiled by the port at first use) and the numpy parser give equal
arrays; the generated stock-format file is byte-equal to the reference
tool's; a native parser that cannot be built raises."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam_cuda_tpu.vocab import load_orbvoc_text as jload
from orb_slam_cuda_tpu_torch.utils import convert
from orb_slam_cuda_tpu_torch.vocab import load_orbvoc_text, native_loader, stock_scale, vocabulary
from test_vocab_io import write_toy_vocab
from torch_parity import to_np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEVEL_FIELDS = ("children_packed", "children_valid", "child_base", "node_word")


def assert_vocab_equal(a, b):
    """a, b: vocabularies of either package; every array exact."""
    assert (a.k, a.depth, a.levelsup_depth, a.n_words) == (b.k, b.depth, b.levelsup_depth, b.n_words)
    for f in LEVEL_FIELDS:
        la, lb = getattr(a, f), getattr(b, f)
        assert len(la) == len(lb) == a.depth
        for lvl, (x, y) in enumerate(zip(la, lb)):
            np.testing.assert_array_equal(to_np(x), to_np(y), err_msg=f"{f}[{lvl}]")
    np.testing.assert_array_equal(to_np(a.word_weight), to_np(b.word_weight))


def assert_transform_equal(jvoc, tvoc, n=500, seed=1):
    d = np.random.default_rng(seed).integers(0, 2**32, (n, 8), dtype=np.uint32)
    jw, jn, jwt = jvoc.transform(jnp.asarray(d))
    tw, tn, twt = tvoc.transform(torch.from_numpy(d.view(np.int32)))
    np.testing.assert_array_equal(to_np(jw), to_np(tw), err_msg="word ids")
    np.testing.assert_array_equal(to_np(jn), to_np(tn), err_msg="levelsup nodes")
    np.testing.assert_array_equal(to_np(jwt), to_np(twt), err_msg="weights")
    return to_np(tw), to_np(tn), to_np(twt)


def write_irregular(path):
    """test_vocab_io.py's irregular tree: root -> node1 (EARLY LEAF, weight
    7.5), node2 (internal, 2 of k=3 children: leaves node3, node4)."""
    d1 = np.zeros(32, np.int64)
    d2 = np.full(32, 255, np.int64)
    d3 = d2.copy()
    d3[0] = 0
    d4 = d2.copy()
    d4[31] = 0
    lines = ["3 2 0 0"]
    for parent, leaf, desc, w in [(0, 1, d1, 7.5), (0, 0, d2, 0.0), (2, 1, d3, 1.25), (2, 1, d4, 2.0)]:
        lines.append(f"{parent} {leaf} " + " ".join(str(x) for x in desc) + f" {w}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return np.stack([d1, d3, d4]).astype(np.uint8)


@pytest.mark.parametrize("parser", vocabulary.PARSERS)
def test_round_trip_matches_reference(rng, tmp_path, parser):
    p = str(tmp_path / "voc.txt")
    write_toy_vocab(p, rng)
    jvoc, tvoc = jload(p, levelsup=1), load_orbvoc_text(p, levelsup=1, parser=parser)
    assert tvoc.k == 3 and tvoc.n_words == 9
    assert_vocab_equal(jvoc, tvoc)
    words, _, _ = assert_transform_equal(jvoc, tvoc)
    assert (words >= 0).all() and (words < 9).all()


@pytest.mark.parametrize("parser", vocabulary.PARSERS)
def test_irregular_tree_early_leaves(tmp_path, parser):
    p = str(tmp_path / "voc_irregular.txt")
    q = write_irregular(p)
    jvoc, tvoc = jload(p, levelsup=1), load_orbvoc_text(p, levelsup=1, parser=parser)
    assert tvoc.n_words == 3
    assert_vocab_equal(jvoc, tvoc)
    assert_transform_equal(jvoc, tvoc)
    packed = np.frombuffer(q.tobytes(), np.uint32).reshape(3, 8)
    word, node, w = tvoc.transform(torch.from_numpy(packed.view(np.int32).copy()))
    # d1 ends at the depth-1 early leaf (word 0, weight 7.5, a negative
    # node id of its own); d3/d4 descend through node2 to the bottom.
    assert word.tolist() == [0, 1, 2]
    np.testing.assert_allclose(w.numpy(), [7.5, 1.25, 2.0], atol=1e-6)
    jn = to_np(jvoc.transform(jnp.asarray(packed))[1])
    np.testing.assert_array_equal(node.numpy(), jn)


def test_native_parser_equals_numpy_parser(rng, tmp_path):
    p = str(tmp_path / "voc.txt")
    write_toy_vocab(p, rng, k=4, depth=2)
    k, depth, parents, is_leaf, desc, weights = native_loader.parse_orbvoc_text(p)
    k2, depth2, parents2, is_leaf2, desc2, weights2 = vocabulary.parse_orbvoc_numpy(p)
    assert (k, depth) == (k2, depth2) == (4, 2)
    assert len(parents) == 4 + 16 and is_leaf.sum() == 16
    for a, b in ((parents, parents2), (is_leaf, is_leaf2), (desc, desc2), (weights, weights2)):
        np.testing.assert_array_equal(a, b)
    line = open(p).read().splitlines()[1].split()
    assert parents[0] == int(line[0])
    np.testing.assert_array_equal(desc[0], [int(x) for x in line[2:34]])
    assert_vocab_equal(load_orbvoc_text(p, levelsup=1), load_orbvoc_text(p, levelsup=1, parser="numpy"))


def test_native_library_is_the_ports_own_build():
    """The scanner is compiled into build/native/ from native/vocab_loader.cpp
    with portable flags; the library tracked under native/lib/ is not opened."""
    path = native_loader.build()
    assert os.path.dirname(path) == os.path.join(REPO, "build", "native")
    assert os.path.exists(path) and native_loader.build() == path
    assert not any(f.startswith("-march") for f in native_loader.FLAGS)
    assert native_loader.SOURCE == os.path.join(REPO, "native", "vocab_loader.cpp")


@pytest.fixture(scope="module")
def stock_l4(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("voc") / "orbvoc_k10_L4.txt")
    stock_scale.generate(path, depth=4)
    return path


def test_generator_text_equals_reference_tool(stock_l4, tmp_path, monkeypatch):
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import bench_vocab_scale

    monkeypatch.setattr(bench_vocab_scale, "DEPTH", 4)
    ref = str(tmp_path / "ref.txt")
    bench_vocab_scale.generate(ref)
    with open(ref, "rb") as a, open(stock_l4, "rb") as b:
        assert a.read() == b.read()


def test_stock_format_l4_matches_reference(stock_l4):
    """k=10, L=4: 11,110 nodes less the dropped subtrees, early leaves at
    depth 3, levelsup 4 clamped to depth 1."""
    jvoc, tvoc = jload(stock_l4), load_orbvoc_text(stock_l4)
    assert tvoc.k == 10 and tvoc.depth == 4 and tvoc.levelsup_depth == 1
    assert 9000 < tvoc.n_words < 10000
    assert int((tvoc.node_word[2] >= 0).sum()) > 0, "fixture should hold early leaves"
    assert_vocab_equal(jvoc, tvoc)
    assert_transform_equal(jvoc, tvoc)
    assert_vocab_equal(tvoc, load_orbvoc_text(stock_l4, parser="numpy"))


@pytest.mark.parametrize("levelsup,want", [(1, 3), (2, 2), (4, 1), (9, 1)])
def test_levelsup_counts_from_the_leaves(stock_l4, levelsup, want):
    tvoc = load_orbvoc_text(stock_l4, levelsup=levelsup, parser="numpy")
    assert tvoc.levelsup_depth == want == jload(stock_l4, levelsup=levelsup).levelsup_depth


def test_loader_reports_its_step_times(stock_l4):
    steps = {}
    tvoc = load_orbvoc_text(stock_l4, timings=steps)
    assert set(steps) == {"parse", "assemble", "nodes"}
    assert steps["parse"] > 0 and steps["assemble"] > 0 and steps["nodes"] > tvoc.n_words


def test_chip_smoke_vocabulary_phase_goes_through_the_loader(monkeypatch):
    """chip_smoke.py's vocabulary phase (rehearsed on the CPU at L=4) calls
    `load_orbvoc_text` once, with the default native parser, on the file it
    generated, and returns what the loader gave."""
    import os
    import sys

    import orb_slam_cuda_tpu_torch.vocab as vocab_pkg

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import chip_smoke

    calls = []

    def counting(path, *args, **kw):
        calls.append((path, args, {k: v for k, v in kw.items() if k != "timings"}))
        return load_orbvoc_text(path, *args, **kw)

    monkeypatch.setattr(vocab_pkg, "load_orbvoc_text", counting)
    got = chip_smoke.phase_vocabulary(device="cpu", depth_l=4)
    assert len(calls) == 1 and calls[0][1:] == ((), {})
    assert calls[0][0].endswith("orbvoc_k10_L4.txt")
    assert_vocab_equal(got, load_orbvoc_text(calls[0][0]))


def test_converted_reference_vocabulary_equals_loaded(stock_l4):
    """utils/convert.py carries a text-loaded reference vocabulary across."""
    assert_vocab_equal(convert.vocabulary(jload(stock_l4)), load_orbvoc_text(stock_l4))


def test_failed_native_build_raises_not_switches(rng, tmp_path, monkeypatch):
    p = str(tmp_path / "voc.txt")
    write_toy_vocab(p, rng)
    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setattr(native_loader, "BUILD_DIR", str(tmp_path / "nobuild"))
    monkeypatch.setattr(native_loader, "COMPILER", "no-such-compiler")
    with pytest.raises(RuntimeError, match="native vocabulary parser"):
        load_orbvoc_text(p, levelsup=1)
    monkeypatch.setattr(native_loader, "COMPILER", "false")
    with pytest.raises(RuntimeError, match="failed"):
        load_orbvoc_text(p, levelsup=1)
    assert load_orbvoc_text(p, levelsup=1, parser="numpy").n_words == 9
    with pytest.raises(ValueError, match="parser"):
        load_orbvoc_text(p, parser="python")
