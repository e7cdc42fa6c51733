"""The port's sharded classify (``dsp_tpu_torch/parallel/sharding.py``:
``classify_sharded`` with k = 1 and k = 3, the full distances, a padded
bank, the all-dead sentinel, and ``recognize_sharded``) in real gloo worlds of 4 and 2 processes, against the JAX package's sharded
functions on a mesh of the same shape (8 fake XLA CPU devices,
``tests/conftest.py``) and against the port's single-device functions.

One 4-rank world runs every path on the meshes (1, 4), (2, 2) and (4, 1),
and one 2-rank world on (1, 2) (``tests/torch_mesh_rank.py``: each rank
imports neither jax nor ``dsp_tpu``).  Every rank must return the same
global result.

Tolerances, each that of the port's single-device test of the same
function against JAX: DTW distances at rtol 1e-5 (tests/test_torch_dtw.py,
the plain scan on both sides); the front-end pipeline's distances at rtol
1e-3 (tests/test_torch_pipeline.py).  Labels are equal; a label that
differs only at a near-tie (two candidates within 1e-4 relative) is
counted and printed, not failed.  Against the port's own single-device
path the sharded distances are bit-equal: each pair's scan does not depend
on the batch shape.  The DP paths are in tests/test_torch_mesh_dp.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsp_tpu import parallel as jpar
from dsp_tpu import pipeline as jpl
from dsp_tpu.config import PipelineConfig as JPipelineConfig
from dsp_tpu.io.dataset import synth_word as jsynth_word
from dsp_tpu.ops import frontend as jfe

from dsp_tpu_torch import pipeline as tpl
from dsp_tpu_torch.config import DtwConfig, PipelineConfig

import torch_mesh_rank as ranks

SHAPES4 = [(1, 4), (2, 2), (4, 1)]
SHAPES2 = [(1, 2)]
SHAPES = SHAPES4 + SHAPES2
CFG = PipelineConfig()


def _random_problem(rng, b=8, k=8, t=30, u=26, f=13):
    q = rng.standard_normal((b, t, f)).astype(np.float32)
    bank = rng.standard_normal((k, u, f)).astype(np.float32)
    ql = rng.integers(5, t + 1, size=b).astype(np.int32)
    bl = rng.integers(5, u + 1, size=k).astype(np.int32)
    ids = rng.integers(0, 3, size=k).astype(np.int32)
    return q, ql, bank, bl, ids


def _inputs():
    inp = dict(zip(("q", "ql", "bank", "bl", "ids"),
                   _random_problem(np.random.default_rng(0))))
    _, _, inp["bank5"], inp["bl5"], inp["ids5"] = _random_problem(
        np.random.default_rng(1), k=5)
    # the whole pipeline: 4 words x 2 templates, 8 queries
    labels = ["zero", "one", "two", "three"]
    bank_sigs = np.stack([jsynth_word(lab, i, max_samples=CFG.max_samples)
                          for lab in labels for i in range(2)])
    jcfg = JPipelineConfig()
    bank = jpl.extract_features(jnp.asarray(bank_sigs),
                                jnp.full(8, CFG.max_samples, jnp.int32),
                                jfe.make_matrices(jcfg.frontend), jcfg)
    inp["rbank"], inp["rbl"] = np.asarray(bank.feats), np.asarray(bank.length)
    inp["rids"] = np.repeat(np.arange(4, dtype=np.int32), 2)
    inp["sigs"] = np.stack([jsynth_word(lab, 50 + i, max_samples=CFG.max_samples)
                            for i, lab in enumerate(labels * 2)])
    inp["ns"] = np.full(8, CFG.max_samples, np.int32)
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
                                                parts=np.asarray(["classify"])))
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


def _labels_equal(got, want, scores, ids, what):
    """Label ids equal, except rows where the two labels' best scores sit
    within 1e-4 relative (near-ties): those are counted and printed."""
    got, want = np.asarray(got), np.asarray(want)
    bad = np.flatnonzero(got != want)
    ties = 0
    for row in bad:
        best = {lab: np.min(np.where(ids == lab, scores[row], np.inf))
                for lab in (got[row], want[row])}
        a, b = best[got[row]], best[want[row]]
        assert abs(a - b) <= 1e-4 * max(abs(a), abs(b)), \
            f"{what}: row {row} label {got[row]} != {want[row]} ({a} vs {b})"
        ties += 1
    if ties:
        print(f"{what}: {ties} near-tie label(s)")


def _single_dtw(bank, bl):
    return tpl.dtw_pairs(torch.from_numpy(INP["q"]), torch.from_numpy(INP["ql"]),
                         torch.from_numpy(bank), torch.from_numpy(bl),
                         DtwConfig()).numpy()


@pytest.mark.parametrize("shape", SHAPES)
def test_classify_k1_and_full_distances(worlds, shape):
    ids_, dist = _res(worlds, shape, "k1")
    _, full = _res(worlds, shape, "full")
    q, ql, bank, bl, ids = (INP[k] for k in ("q", "ql", "bank", "bl", "ids"))
    mesh = _jmesh(shape)
    qd, qld = jpar.shard_queries(mesh, q, ql)
    bd, bld = jpar.shard_bank(mesh, bank, bl)
    want_ids, want_dist = jpar.classify_sharded(mesh, qd, qld, bd, bld,
                                                jpar.replicate(mesh, ids))
    _, want_full = jpar.classify_sharded(mesh, qd, qld, bd, bld,
                                         jpar.replicate(mesh, ids),
                                         return_full=True)
    _labels_equal(ids_, want_ids, np.asarray(want_full), ids, "k1 vs JAX")
    np.testing.assert_allclose(dist, np.asarray(want_dist), rtol=1e-5)
    np.testing.assert_allclose(full, np.asarray(want_full), rtol=1e-5)
    # the port's single device: the same scan per pair, bit for bit
    single = _single_dtw(bank, bl)
    np.testing.assert_array_equal(full, single)
    np.testing.assert_array_equal(dist, single.min(axis=1))
    np.testing.assert_array_equal(ids_, ids[single.argmin(axis=1)])


@pytest.mark.parametrize("shape", SHAPES)
def test_classify_knn_k3(worlds, shape):
    got, dist = _res(worlds, shape, "k3")
    q, ql, bank, bl, ids = (INP[k] for k in ("q", "ql", "bank", "bl", "ids"))
    mesh = _jmesh(shape)
    qd, qld = jpar.shard_queries(mesh, q, ql)
    bd, bld = jpar.shard_bank(mesh, bank, bl)
    want, want_d = jpar.classify_sharded(mesh, qd, qld, bd, bld,
                                         jpar.replicate(mesh, ids), k=3,
                                         n_labels=3)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_allclose(dist, np.asarray(want_d), rtol=1e-5)
    single = tpl.knn_vote(torch.from_numpy(_single_dtw(bank, bl)),
                          torch.from_numpy(ids), 3, 3).numpy()
    np.testing.assert_array_equal(got, single)


@pytest.mark.parametrize("shape", SHAPES)
def test_classify_padded_bank(worlds, shape):
    """K = 5 padded to the bank axis: padding templates are never chosen,
    by the argmin or by the vote."""
    got1, _ = _res(worlds, shape, "pad_k1")
    got3, _ = _res(worlds, shape, "pad_k3")
    single = _single_dtw(INP["bank5"], INP["bl5"])
    ids = INP["ids5"]
    np.testing.assert_array_equal(got1, ids[single.argmin(axis=1)])
    want3 = tpl.knn_vote(torch.from_numpy(single), torch.from_numpy(ids), 3, 3)
    np.testing.assert_array_equal(got3, want3.numpy())
    mesh = _jmesh(shape)
    nb = shape[1]
    bp, k_orig = jpar.pad_axis_to_multiple(INP["bank5"], nb)
    blp, _ = jpar.pad_axis_to_multiple(INP["bl5"], nb)
    idsp, _ = jpar.pad_axis_to_multiple(ids, nb)
    qd, qld = jpar.shard_queries(mesh, INP["q"], INP["ql"])
    bd, bld, vd = jpar.shard_bank(mesh, bp, np.maximum(blp, 1),
                                  np.arange(bp.shape[0]) < k_orig)
    want, _ = jpar.classify_sharded(mesh, qd, qld, bd, bld,
                                    jpar.replicate(mesh, idsp), vd)
    np.testing.assert_array_equal(got1, np.asarray(want))


@pytest.mark.parametrize("shape", SHAPES)
def test_classify_all_dead_sentinel(worlds, shape):
    """Every template invalid: k = 1 and the vote both return -1."""
    got1, d1 = _res(worlds, shape, "dead_k1")
    got3, _ = _res(worlds, shape, "dead_k3")
    assert (got1 == -1).all() and (got3 == -1).all()
    assert (d1 >= 1e20).all()
    mesh = _jmesh(shape)
    q, ql, bank, bl, ids = (INP[k] for k in ("q", "ql", "bank", "bl", "ids"))
    qd, qld = jpar.shard_queries(mesh, q, ql)
    bd, bld, vd = jpar.shard_bank(mesh, bank, bl, np.zeros(8, bool))
    want, _ = jpar.classify_sharded(mesh, qd, qld, bd, bld,
                                    jpar.replicate(mesh, ids), vd)
    np.testing.assert_array_equal(got1, np.asarray(want))


@pytest.mark.parametrize("shape", SHAPES)
def test_recognize_sharded(worlds, shape):
    got, dist = _res(worlds, shape, "rec")
    mesh = _jmesh(shape)
    jcfg = JPipelineConfig()
    sd, nd_ = jpar.shard_queries(mesh, INP["sigs"], INP["ns"])
    want, want_d = jpar.recognize_sharded(
        mesh, sd, nd_, jfe.make_matrices(jcfg.frontend),
        jpar.shard_bank(mesh, INP["rbank"]), jpar.shard_bank(mesh, INP["rbl"]),
        jpar.replicate(mesh, INP["rids"]), cfg=jcfg)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got, np.tile(np.arange(4), 2))
    np.testing.assert_allclose(dist, np.asarray(want_d), rtol=1e-3)
    single_ids, single_d = tpl.recognize_batch(
        torch.from_numpy(INP["sigs"]), torch.from_numpy(INP["ns"]),
        tpl.Features(torch.from_numpy(INP["rbank"]), torch.from_numpy(INP["rbl"])),
        torch.from_numpy(INP["rids"]), CFG)
    np.testing.assert_array_equal(got, single_ids.numpy())
    np.testing.assert_allclose(dist, single_d.numpy().min(axis=1), rtol=1e-6)


def test_every_rank_saw_its_world(worlds):
    """The 4-rank world ran four processes and the 2-rank world two, each
    writing the same global results."""
    assert len(worlds[(2, 2)]) == 4 and len(worlds[(1, 2)]) == 2
