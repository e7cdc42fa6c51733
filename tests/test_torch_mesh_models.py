"""The recognizers' ``mesh=`` entry points in real gloo worlds of 4 and 2
processes: ``KnnDtwRecognizer`` (classify with k = 1 and k = 3, the full
distances, n-best, ``classify_connected`` by the VAD split, by level
building and under a grammar), ``pipeline.decode_connected_level(mesh=)``,
``KeywordSpotter`` over a meshed recognizer, and ``VqRecognizer``.

Every path runs on the meshes (1, 4), (2, 2), (4, 1) in one 4-rank world
and (1, 2) in a 2-rank world (``tests/torch_mesh_rank.py``), on a bank the
JAX package enrolled.  Each shape is held to the port's single-device
recognizer on the same bank, and the (2, 2) mesh also to the JAX
package's recognizers on a (2, 2) mesh (JAX compiles each mesh shape's
programs anew, ~40 s a shape here, so the other shapes meet JAX through
the single-device path, which the port's own tests hold to JAX).

Tolerances: labels, decoded word lists, spotting witnesses and events
equal; DTW distances at rtol 1e-3 and spotting norms at rtol 1e-3 against
JAX (tests/test_torch_pipeline.py, tests/test_torch_spotter.py: the
front-ends agree to ~1e-4), VQ distortions at rtol 1e-4
(tests/test_torch_vq.py), level-building costs at rtol 1e-3.  Against the
port's single device: distances bit-equal for classify (the same features
and scan per pair) and at rtol 1e-5 where the batch is padded to the mesh
before a front-end GEMM (spotting, level building, VQ).
"""

import json

import numpy as np
import pytest
import torch

from dsp_tpu import KnnDtwRecognizer as JaxRecognizer
from dsp_tpu import parallel as jpar
from dsp_tpu import pipeline as jpl
from dsp_tpu.config import PipelineConfig as JPipelineConfig
from dsp_tpu.config import VqConfig as JVqConfig
from dsp_tpu.io.dataset import make_corpus
from dsp_tpu.models.spotter import KeywordSpotter as JaxSpotter
from dsp_tpu.models.vq import VqRecognizer as JaxVq

from dsp_tpu_torch import KeywordSpotter, KnnDtwRecognizer, PipelineConfig
from dsp_tpu_torch import VqRecognizer
from dsp_tpu_torch import pipeline as tpl
from dsp_tpu_torch.config import VqConfig
from dsp_tpu_torch.io import synth_connected, synth_spotting_stream, synth_word

import torch_mesh_rank as ranks

SHAPES4 = [(1, 4), (2, 2), (4, 1)]
SHAPES2 = [(1, 2)]
SHAPES = SHAPES4 + SHAPES2
LABELS = ["zero", "one", "two"]
QUERIES = [synth_word(LABELS[i % 3], 40 + i) for i in range(5)]
CONN = [synth_connected(["two", "zero", "one"], seed=5, gap_ms=(0.0, 1.0),
                        lead_ms=(50.0, 60.0)),
        synth_connected(["one", "two"], seed=9)]
SPOT = [synth_spotting_stream(["zero", "one"], LABELS + ["four", "five"], seed=s,
                              n_words=4)[0] for s in (2, 7)]
SPOT_THR = 40.0
REROUTE = {"start": ["zero", "one"]}


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
def jax_rec():
    rec = JaxRecognizer(JPipelineConfig())
    for lab in LABELS:
        rec.enroll(lab, [synth_word(lab, i) for i in range(2)])
    return rec


@pytest.fixture(scope="module")
def jax_vq():
    rec = JaxVq(JPipelineConfig(), JVqConfig(n_codes=16, n_iter=4))
    rec.fit(make_corpus(LABELS, n_per_word=2, seed=0))
    return rec


def _port_rec(jax_rec, k=1, mesh=None):
    return KnnDtwRecognizer.from_arrays(
        np.stack(jax_rec._bank_feats), jax_rec._bank_lens,
        jax_rec._bank_label_ids, jax_rec.labels, PipelineConfig(), k=k,
        device="cpu", mesh=mesh)


@pytest.fixture(scope="module")
def worlds(jax_rec, jax_vq, tmp_path_factory):
    inp = {"bank": np.stack(jax_rec._bank_feats),
           "lens": np.asarray(jax_rec._bank_lens, np.int32),
           "label_ids": np.asarray(jax_rec._bank_label_ids, np.int32),
           "labels": np.asarray(json.dumps(jax_rec.labels)),
           "codebooks": np.asarray(jax_vq.codebooks),
           "spot_thr": np.asarray(SPOT_THR),
           **ranks.pack_signals("queries", QUERIES),
           **ranks.pack_signals("conn", CONN),
           **ranks.pack_signals("spot", SPOT)}
    assert jax_vq.labels == jax_rec.labels == LABELS
    out = {}
    for world, shapes in ((4, SHAPES4), (2, SHAPES2)):
        got = ranks.run_world(tmp_path_factory.mktemp(f"w{world}"), world,
                              "models", dict(inp, shapes=np.asarray(shapes)))
        for r in got[1:]:                      # the same result on every rank
            assert r.keys() == got[0].keys()
            for key in r:
                np.testing.assert_array_equal(r[key], got[0][key], err_msg=key)
        for nd, nb in shapes:
            out[(nd, nb)] = {k.split(":", 1)[1]: v for k, v in got[0].items()
                             if k.startswith(f"{nd}x{nb}:")}
    return out


@pytest.fixture(scope="module")
def single(jax_rec, jax_vq):
    """The port's single-device results on the same bank."""
    r1, r3 = _port_rec(jax_rec), _port_rec(jax_rec, k=3)
    out = {}
    out["k1"], out["k1_d"] = r1.classify_batch(QUERIES, return_distances=True)
    out["k3"], out["k3_d"] = r3.classify_batch(QUERIES, return_distances=True)
    out["nbest"] = r3.classify_nbest(QUERIES)
    out["conn"] = {
        "vad": r1.classify_connected(CONN, max_segments=4),
        "level": r1.classify_connected(CONN, max_segments=4, method="level"),
        "grammar": r1.classify_connected(CONN, max_segments=4, method="level",
                                         grammar={"no_repeat": True})}
    out["dcl"], out["dcl_cost"] = tpl.decode_connected_level(
        CONN, r1.cfg, *r1.device_bank(), max_levels=4,
        grammar_masks=r1.resolve_grammar(REROUTE), device="cpu")
    spotter = KeywordSpotter(r1, threshold=SPOT_THR)
    out["spot"] = spotter.scores(SPOT)
    out["events"] = spotter.spot(SPOT)
    vq = VqRecognizer(PipelineConfig(), VqConfig(n_codes=16), device="cpu")
    vq.labels, vq.codebooks = LABELS, np.asarray(jax_vq.codebooks)
    out["vq"], out["vq_d"] = vq.classify_batch(QUERIES, return_distances=True)
    return out


@pytest.fixture(scope="module")
def jax_meshed(jax_rec, jax_vq):
    """The JAX package's recognizers on a (2, 2) mesh."""
    mesh = jpar.make_mesh(2, 2)
    out = {}

    def rec(k):
        r = JaxRecognizer(JPipelineConfig(), k=k, mesh=mesh)
        r.labels, r._bank_feats = jax_rec.labels, jax_rec._bank_feats
        r._bank_lens, r._bank_label_ids = jax_rec._bank_lens, jax_rec._bank_label_ids
        return r

    r1, r3 = rec(1), rec(3)
    out["k1"], out["k1_d"] = r1.classify_batch(QUERIES, return_distances=True)
    out["k3"], out["k3_d"] = r3.classify_batch(QUERIES, return_distances=True)
    out["conn"] = {
        "vad": r1.classify_connected(CONN, max_segments=4),
        "level": r1.classify_connected(CONN, max_segments=4, method="level"),
        "grammar": r1.classify_connected(CONN, max_segments=4, method="level",
                                         grammar={"no_repeat": True})}
    bf, bl, ids, valid = r1.sharded_bank()
    out["dcl"], out["dcl_cost"] = jpl.decode_connected_level(
        CONN, r1.mats, r1.cfg, jpl.Features(bf, bl), np.asarray(ids),
        max_levels=4, mesh=mesh, bank_valid=valid,
        grammar_masks=r1.resolve_grammar(REROUTE))
    spotter = JaxSpotter(r1, threshold=SPOT_THR)
    out["spot"] = spotter.scores(SPOT)
    out["events"] = spotter.spot(SPOT)
    vq = JaxVq(JPipelineConfig(), JVqConfig(n_codes=16, n_iter=4), mesh=mesh)
    vq.labels, vq.codebooks = LABELS, jax_vq.codebooks
    out["vq"], out["vq_d"] = vq.classify_batch(QUERIES, return_distances=True)
    return out


@pytest.mark.parametrize("shape", SHAPES)
def test_classify_batch_k1(worlds, single, shape):
    got = worlds[shape]
    assert list(got["k1"]) == single["k1"] == [LABELS[i % 3] for i in range(5)]
    np.testing.assert_array_equal(got["k1_d"], single["k1_d"])


@pytest.mark.parametrize("shape", SHAPES)
def test_classify_batch_knn_k3_and_nbest(worlds, single, shape):
    got = worlds[shape]
    assert list(got["k3"]) == single["k3"]
    np.testing.assert_array_equal(got["k3_d"], single["k3_d"])
    assert json.loads(str(got["nbest"])) == json.loads(json.dumps(single["nbest"]))


@pytest.mark.parametrize("shape", SHAPES)
def test_classify_connected(worlds, single, shape):
    conn = json.loads(str(worlds[shape]["conn"]))
    assert conn == single["conn"]
    assert conn["level"] == conn["grammar"] == [["two", "zero", "one"], ["one", "two"]]


@pytest.mark.parametrize("shape", SHAPES)
def test_decode_connected_level_mesh(worlds, single, shape):
    """The pipeline entry point with a grammar that forbids the truth's
    first word: the masks are padded to the mesh's bank."""
    got = worlds[shape]
    assert json.loads(str(got["dcl"])) == single["dcl"]
    assert single["dcl"][0][0] != 2                   # rerouted off "two"
    np.testing.assert_allclose(got["dcl_cost"], single["dcl_cost"], rtol=1e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_keyword_spotter_mesh(worlds, single, shape):
    got = worlds[shape]
    for i, (norm, start) in enumerate(single["spot"]):
        np.testing.assert_allclose(got[f"spot_norm{i}"], norm, rtol=1e-5)
        np.testing.assert_array_equal(got[f"spot_start{i}"], start)
    events = json.loads(str(got["events"]))
    want = json.loads(json.dumps(single["events"]))
    assert [[e[:3] for e in r] for r in events] == [[e[:3] for e in r] for r in want]
    assert any(events)


@pytest.mark.parametrize("shape", SHAPES)
def test_vq_mesh(worlds, single, shape):
    got = worlds[shape]
    assert list(got["vq"]) == single["vq"]
    np.testing.assert_allclose(got["vq_d"], single["vq_d"], rtol=1e-5)


def test_mesh_2x2_matches_jax_mesh(worlds, jax_meshed):
    """Every entry point on the (2, 2) mesh against the JAX package's
    recognizers on a (2, 2) mesh."""
    got, want = worlds[(2, 2)], jax_meshed
    assert list(got["k1"]) == want["k1"]
    np.testing.assert_allclose(got["k1_d"], want["k1_d"], rtol=1e-3)
    assert list(got["k3"]) == want["k3"]
    np.testing.assert_allclose(got["k3_d"], want["k3_d"], rtol=1e-3)
    assert json.loads(str(got["conn"])) == want["conn"]
    jax_labels = [[int(i) for i in ids] for ids in want["dcl"]]
    assert json.loads(str(got["dcl"])) == jax_labels
    np.testing.assert_allclose(got["dcl_cost"], want["dcl_cost"], rtol=1e-3)
    for i, (norm, start) in enumerate(want["spot"]):
        np.testing.assert_allclose(got[f"spot_norm{i}"], norm, rtol=1e-3)
        np.testing.assert_array_equal(got[f"spot_start{i}"], start)
    events = json.loads(str(got["events"]))
    assert [[e[:3] for e in r] for r in events] == \
        [[list(e[:3]) for e in r] for r in want["events"]]
    assert list(got["vq"]) == want["vq"]
    np.testing.assert_allclose(got["vq_d"], want["vq_d"], rtol=1e-4)
