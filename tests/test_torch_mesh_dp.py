"""The port's sharded DP functions (``dsp_tpu_torch/parallel/sharding.py``:
``spot_sharded``, ``level_build_sharded``, ``level_build_grammar_sharded``)
in real gloo worlds of 4 and 2 processes, against the JAX package's sharded
functions on a mesh of the same shape (8 fake XLA CPU devices,
``tests/conftest.py``) and against the port's single-device functions.

One 4-rank world runs every path on the meshes (1, 4), (2, 2) and (4, 1),
and one 2-rank world on (1, 2) (``tests/torch_mesh_rank.py``: each rank
imports neither jax nor ``dsp_tpu``).  Every rank must return the same
global result.

Tolerances, each that of the port's single-device test of the same
function against JAX: spotting norms at rtol 2e-4, atol 1e-5
(tests/test_torch_spot.py), witnesses equal; level-building costs at
rtol/atol 1e-5 on the live cells (tests/test_torch_level_building.py),
words, starts and the live pattern equal.  Against the port's single
device the spotting planes are bit-equal (the same plain route per
pair), and the level-building costs are held at the same 1e-5: the local
cost is a ``[B, F] @ [F, K*U]`` GEMM a frame whose shape follows the shard
(the largest gap is printed: 0 on these inputs; ROADMAP.md queue 3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsp_tpu import parallel as jpar
from dsp_tpu.parallel.sharding import (level_build_grammar_sharded as
                                       jlevel_build_grammar_sharded)
from dsp_tpu.parallel.sharding import level_build_sharded as jlevel_build_sharded

from dsp_tpu_torch.ops import level_building as tlb
from dsp_tpu_torch.ops import spot as tspot

import torch_mesh_rank as ranks

SHAPES4 = [(1, 4), (2, 2), (4, 1)]
SHAPES2 = [(1, 2)]
SHAPES = SHAPES4 + SHAPES2
BIG = tlb.BIG


def _inputs():
    inp = {}
    rng = np.random.default_rng(2)
    inp["streams"] = rng.standard_normal((4, 40, 13)).astype(np.float32)
    inp["slens"] = np.asarray([40, 31, 25, 38], np.int32)
    inp["sbank"] = rng.standard_normal((6, 10, 13)).astype(np.float32)
    inp["sbl"] = rng.integers(4, 11, size=6).astype(np.int32)
    rng = np.random.default_rng(4)
    inp["lq"] = rng.standard_normal((8, 20, 5)).astype(np.float32)
    inp["lql"] = np.full(8, 20, np.int32)
    inp["lbank"] = rng.standard_normal((8, 10, 5)).astype(np.float32)
    inp["lbl"] = rng.integers(4, 11, size=8).astype(np.int32)
    rng = np.random.default_rng(5)
    inp["lq6"] = rng.standard_normal((4, 16, 4)).astype(np.float32)
    inp["lql6"] = np.full(4, 16, np.int32)
    inp["lbank6"] = rng.standard_normal((6, 8, 4)).astype(np.float32)
    inp["lbl6"] = rng.integers(3, 9, size=6).astype(np.int32)
    # grammar: a bank of 6 padded to 8, the pad rows out of the grammar
    rng = np.random.default_rng(31)
    b, k, t, u, f, kp = 8, 6, 14, 7, 4, 8
    inp["gq"] = rng.standard_normal((b, t, f)).astype(np.float32)
    gbank = rng.standard_normal((k, u, f)).astype(np.float32)
    inp["gql"] = np.full(b, t, np.int32)
    gbl = rng.integers(3, u + 1, size=k).astype(np.int32)
    start = rng.random(k) < 0.7
    pairs = rng.random((k, k)) < 0.7
    end = rng.random(k) < 0.7
    start[0] = end[0] = True
    pairs[np.arange(k), (np.arange(k) + 1) % k] = True
    inp["gbank"] = np.concatenate([gbank, np.zeros((kp - k, u, f), np.float32)])
    inp["gbl"] = np.concatenate([gbl, np.ones(kp - k, np.int32)])
    inp["gvalid"] = np.arange(kp) < k
    inp["gstart"] = np.concatenate([start, np.zeros(kp - k, bool)])
    inp["gpairs"] = np.zeros((kp, kp), bool)
    inp["gpairs"][:k, :k] = pairs
    inp["gend"] = np.concatenate([end, np.zeros(kp - k, bool)])
    return inp


INP = _inputs()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the single-device references here are loops of
    small ops, which crawl when parallel test workers (and this file's
    rank processes) oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Each rank's outputs by mesh shape: one 4-rank and one 2-rank world."""
    out = {}
    for world, shapes in ((4, SHAPES4), (2, SHAPES2)):
        got = ranks.run_world(tmp_path_factory.mktemp(f"w{world}"), world,
                              "functions", dict(INP, shapes=np.asarray(shapes),
                                                parts=np.asarray(["dp"])))
        for nd, nb in shapes:
            out[(nd, nb)] = got
    return out


def _res(worlds, shape, name):
    """The global result of one path, checked equal on every rank."""
    per_rank = worlds[shape]
    tag = f"{shape[0]}x{shape[1]}:{name}:"
    keys = sorted(k for k in per_rank[0] if k.startswith(tag))
    vals = [per_rank[0][k] for k in keys]
    for r in per_rank[1:]:
        for k, v in zip(keys, vals):
            np.testing.assert_array_equal(r[k], v, err_msg=f"rank output {k}")
    return vals


def _jmesh(shape):
    return jpar.make_mesh(*shape)


@pytest.mark.parametrize("shape", SHAPES)
def test_spot_sharded(worlds, shape):
    norm, start = _res(worlds, shape, "spot")
    k = INP["sbank"].shape[0]
    nb = shape[1]
    mesh = _jmesh(shape)
    bp, _ = jpar.pad_axis_to_multiple(INP["sbank"], nb)
    blp, _ = jpar.pad_axis_to_multiple(INP["sbl"], nb)
    sd, sld = jpar.shard_queries(mesh, INP["streams"], INP["slens"])
    bd, bld, vd = jpar.shard_bank(mesh, bp, np.maximum(blp, 1),
                                  np.arange(bp.shape[0]) < k)
    jn, js = jpar.spot_sharded(mesh, sd, sld, bd, bld, vd)
    jn, js = np.asarray(jn)[:, :k], np.asarray(js)[:, :k]
    live = jn < BIG / 2
    np.testing.assert_array_equal(norm < BIG / 2, live)
    np.testing.assert_allclose(norm[live], jn[live], rtol=2e-4, atol=1e-5)
    np.testing.assert_array_equal(start[live], js[live])
    sn, ss = tspot.subseq_dtw_batch(
        torch.from_numpy(INP["streams"]), torch.from_numpy(INP["slens"]),
        torch.from_numpy(INP["sbank"]), torch.from_numpy(INP["sbl"]))
    np.testing.assert_array_equal(norm, sn.numpy())
    np.testing.assert_array_equal(start, ss.numpy())


def _assert_level(got, want, k=None, rtol=1e-5):
    """(costs, words, starts) planes: the live pattern equal, costs at
    ``rtol``, words and starts equal on live cells; returns the largest
    relative cost gap."""
    gc, wc = np.asarray(got[0]), np.asarray(want[0])
    live = wc < BIG / 2
    np.testing.assert_array_equal(gc < BIG / 2, live)
    np.testing.assert_allclose(gc[live], wc[live], rtol=rtol, atol=rtol)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(np.asarray(g)[live], np.asarray(w)[live])
    if k is not None:
        assert (np.asarray(got[1])[live] < k).all()      # pads never win
    return float(np.max(np.abs(gc[live] - wc[live]) / np.abs(wc[live])))


@pytest.mark.parametrize("shape", SHAPES)
def test_level_build_sharded(worlds, shape):
    got = _res(worlds, shape, "level")
    args = [INP[k] for k in ("lq", "lql", "lbank", "lbl")]
    want = jlevel_build_sharded(_jmesh(shape), *map(jnp.asarray, args),
                                max_levels=4, word_penalty=0.2)
    _assert_level(got, want)
    single = tlb.level_build(*map(torch.from_numpy, args), 4, 0.2)
    gap = _assert_level(got, [p.numpy() for p in single])
    print(f"level building {shape}: largest cost gap to one device {gap:.2e}")


@pytest.mark.parametrize("shape", SHAPES)
def test_level_build_sharded_padded_bank(worlds, shape):
    got = _res(worlds, shape, "level_pad")
    k = INP["lbank6"].shape[0]
    single = tlb.level_build(*map(torch.from_numpy, (
        INP["lq6"], INP["lql6"], INP["lbank6"], INP["lbl6"])), 3)
    _assert_level(got, [p.numpy() for p in single], k=k)
    nb = shape[1]
    bp, _ = jpar.pad_axis_to_multiple(INP["lbank6"], nb)
    blp, _ = jpar.pad_axis_to_multiple(INP["lbl6"], nb)
    want = jlevel_build_sharded(
        _jmesh(shape), jnp.asarray(INP["lq6"]), jnp.asarray(INP["lql6"]),
        jnp.asarray(bp), jnp.asarray(np.maximum(blp, 1)),
        jnp.asarray(np.arange(bp.shape[0]) < k), max_levels=3)
    _assert_level(got, want, k=k)


@pytest.mark.parametrize("shape", SHAPES)
def test_level_build_grammar_sharded(worlds, shape):
    """Grammar DP over the mesh == JAX's sharded planes and the port's
    single-device planes; the pad rows are unreachable, and the
    backtracked sequences agree."""
    got_c, got_s = _res(worlds, shape, "grammar")
    names = ("gq", "gql", "gbank", "gbl", "gvalid", "gstart", "gpairs")
    want_c, want_s = (np.asarray(p) for p in jlevel_build_grammar_sharded(
        _jmesh(shape), *(jnp.asarray(INP[n]) for n in names), max_levels=3,
        word_penalty=0.2))
    k = int(INP["gvalid"].sum())
    live = want_c < BIG / 2
    np.testing.assert_array_equal(got_c < BIG / 2, live)
    np.testing.assert_allclose(got_c[live], want_c[live], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got_s[live], want_s[live])
    assert (got_c[..., k:] >= BIG / 2).all()
    sc, ss = (p.numpy() for p in tlb.level_build_grammar(
        *(torch.from_numpy(INP[n]) for n in ("gq", "gql")),
        torch.from_numpy(INP["gbank"][:k]), torch.from_numpy(INP["gbl"][:k]),
        torch.from_numpy(INP["gstart"][:k]),
        torch.from_numpy(INP["gpairs"][:k, :k]), 3, 0.2))
    live = sc < BIG / 2
    np.testing.assert_array_equal(got_c[..., :k] < BIG / 2, live)
    np.testing.assert_allclose(got_c[..., :k][live], sc[live], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got_s[..., :k][live], ss[live])
    pairs, end = INP["gpairs"], INP["gend"]
    for row in range(got_c.shape[0]):
        assert tlb.backtrack_grammar(got_c[row], got_s[row], pairs, end, 14)[0] == \
            tlb.backtrack_grammar(sc[row], ss[row], pairs[:k, :k], end[:k], 14)[0]
