"""Slice parity: the port's pipeline and recognizer against the JAX package.

Features allclose at 5e-3 (tests/test_e2e.py:34, float32 front-ends in
another summation order), lengths and labels equal, distances allclose at
rtol 1e-3 (they sum ~200 local costs of features that agree to ~1e-4).
Banks saved by either package load in the other.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsp_tpu import KnnDtwRecognizer as JaxRecognizer
from dsp_tpu import pipeline as jpl
from dsp_tpu.config import FrontendConfig as JFrontendConfig
from dsp_tpu.config import PipelineConfig as JPipelineConfig
from dsp_tpu.ops import frontend as jfe

from dsp_tpu_torch import KnnDtwRecognizer, PipelineConfig
from dsp_tpu_torch import pipeline as tpl
from dsp_tpu_torch.config import DtwConfig, FrontendConfig
from dsp_tpu_torch.io import synth_word
from dsp_tpu_torch.kernels import _build
from dsp_tpu_torch.kernels import dtw_fused_banded as kdtw
from dsp_tpu_torch.ops import frontend as tfe

LABELS = ["zero", "one", "two"]
BANK = {lab: [synth_word(lab, i) for i in range(2)] for lab in LABELS}
QUERIES = [synth_word(lab, 50 + i) for i, lab in enumerate(LABELS + ["one"])]


@pytest.fixture(scope="module")
def jax_rec():
    rec = JaxRecognizer(JPipelineConfig())
    for lab in LABELS:
        rec.enroll(lab, BANK[lab])
    return rec


@pytest.fixture(scope="module")
def port_rec():
    rec = KnnDtwRecognizer(PipelineConfig(), device="cpu")
    for lab in LABELS:
        rec.enroll(lab, BANK[lab])
    return rec


def _assert_dists_close(got, want):
    assert ((got >= 1e20) == (want >= 1e20)).all()
    fin = want < 1e20
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-3)


@pytest.mark.parametrize("kw", [{}, {"cmn": True},
                                {"cmn": True, "cmn_mode": "causal"}])
def test_extract_features_matches_jax(kw):
    x = np.stack(QUERIES)
    n = np.array([32000, 32000, 20000, 9000], np.int32)
    jcfg = JPipelineConfig(frontend=JFrontendConfig(**kw))
    want = jpl.extract_features(jnp.asarray(x), jnp.asarray(n),
                                jfe.make_matrices(jcfg.frontend), jcfg)
    got = tpl.extract_features(torch.from_numpy(x), torch.from_numpy(n),
                               PipelineConfig(frontend=FrontendConfig(**kw)))
    assert got.feats.shape == (4, 198, 39)
    np.testing.assert_array_equal(got.length.numpy(), np.asarray(want.length))
    np.testing.assert_allclose(got.feats.numpy(), np.asarray(want.feats),
                               rtol=5e-3, atol=5e-3)


def test_extract_features_without_vad_matches_jax():
    x = np.stack(QUERIES[:2])
    n = np.array([32000, 12345], np.int32)
    jcfg = JPipelineConfig(use_vad=False)
    want = jpl.extract_features(jnp.asarray(x), jnp.asarray(n),
                                jfe.make_matrices(jcfg.frontend), jcfg)
    got = tpl.extract_features(torch.from_numpy(x), torch.from_numpy(n),
                               PipelineConfig(use_vad=False))
    np.testing.assert_array_equal(got.length.numpy(), np.asarray(want.length))
    np.testing.assert_allclose(got.feats.numpy(), np.asarray(want.feats),
                               rtol=5e-3, atol=5e-3)


def test_recognize_batch_matches_jax(jax_rec, port_rec):
    x, n = tpl.pad_signals(QUERIES, 32000, device="cpu")
    jbank, jids = jax_rec.device_bank()
    want_ids, want_d = jpl.recognize_batch(jnp.asarray(x.numpy()), jnp.asarray(n.numpy()),
                                           jax_rec.mats, jbank, jids, jax_rec.cfg)
    bank, ids = port_rec.device_bank()
    got_ids, got_d = tpl.recognize_batch(x, n, bank, ids, port_rec.cfg)
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
    _assert_dists_close(got_d.numpy(), np.asarray(want_d))
    assert [LABELS[i] for i in got_ids.tolist()] == LABELS + ["one"]


def test_classify_batch_matches_jax(jax_rec, port_rec):
    want, want_d = jax_rec.classify_batch(QUERIES, return_distances=True)
    got, got_d = port_rec.classify_batch(QUERIES, return_distances=True)
    assert got == want
    _assert_dists_close(got_d, np.asarray(want_d))
    assert port_rec.recognize(QUERIES[1]) == jax_rec.recognize(QUERIES[1])


def test_chunked_classify_equals_one_chunk(port_rec):
    labels, d = port_rec.classify_batch(QUERIES, return_distances=True)
    labels_c, d_c = port_rec.classify_batch(QUERIES, return_distances=True,
                                            chunk=3)
    assert labels_c == labels
    np.testing.assert_array_equal(d_c, d)


def test_knn_vote_matches_jax():
    rng = np.random.default_rng(9)
    d = rng.integers(0, 4, size=(6, 8)).astype(np.float32)   # many ties
    d[0, :] = 1e27                                          # all dead
    d[1, :5] = 1e27
    ids = np.array([0, 1, 2, 0, 1, 2, 0, 1], np.int32)
    for k in (1, 3, 5, 20):
        got = tpl.knn_vote(torch.from_numpy(d), torch.from_numpy(ids), 3, k)
        want = jpl.knn_vote(jnp.asarray(d), jnp.asarray(ids), 3, k)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_knn_classify_matches_jax():
    jrec = JaxRecognizer(JPipelineConfig(), k=3)
    prec = KnnDtwRecognizer(PipelineConfig(), k=3, device="cpu")
    for lab in LABELS:
        jrec.enroll(lab, BANK[lab])
        prec.enroll(lab, BANK[lab])
    assert prec.classify_batch(QUERIES) == jrec.classify_batch(QUERIES)


def test_jax_bank_loads_in_port(jax_rec, tmp_path):
    path = str(tmp_path / "jax_bank.npz")
    jax_rec.save(path)
    rec = KnnDtwRecognizer.load(path, PipelineConfig(), device="cpu")
    assert rec.labels == jax_rec.labels and rec.n_templates == jax_rec.n_templates
    assert rec.classify_batch(QUERIES) == jax_rec.classify_batch(QUERIES)


def test_port_bank_loads_in_jax(port_rec, tmp_path):
    path = str(tmp_path / "port_bank.npz")
    port_rec.save(path)
    rec = JaxRecognizer.load(path, JPipelineConfig())
    assert rec.labels == port_rec.labels and rec.k == port_rec.k
    assert rec.classify_batch(QUERIES) == port_rec.classify_batch(QUERIES)
    jpath = str(tmp_path / "jax_bank.npz")
    rec.save(jpath)
    with np.load(path) as ours, np.load(jpath) as theirs:
        assert sorted(ours.files) == sorted(theirs.files)
        for key in ours.files:
            assert ours[key].dtype == theirs[key].dtype, key


def test_from_arrays_equals_enrolled(port_rec):
    bank, lens = np.stack(port_rec._bank_feats), np.asarray(port_rec._bank_lens)
    rec = KnnDtwRecognizer.from_arrays(bank, lens, port_rec._bank_label_ids,
                                       port_rec.labels, PipelineConfig(),
                                       device="cpu")
    assert rec.classify_batch(QUERIES) == port_rec.classify_batch(QUERIES)
    with pytest.raises(ValueError, match="bank shape"):
        KnnDtwRecognizer.from_arrays(bank[:, :10], lens, port_rec._bank_label_ids,
                                     port_rec.labels, PipelineConfig(),
                                     device="cpu")


def test_frontend_signature_mismatch_refused(port_rec, tmp_path):
    path = str(tmp_path / "bank.npz")
    port_rec.save(path)
    other = PipelineConfig(frontend=FrontendConfig(cmn=True))
    with pytest.raises(ValueError, match="different front-end"):
        KnnDtwRecognizer.load(path, other, device="cpu")


def test_auto_on_cpu_runs_the_scan():
    rng = np.random.default_rng(10)
    q = torch.from_numpy(rng.standard_normal((8, 30, 39)).astype(np.float32))
    lens = torch.full((8,), 30, dtype=torch.int32)
    before = _build.LAUNCHES["dtw_banded"]
    d = tpl.dtw_pairs(q, lens, q, lens, DtwConfig())
    assert _build.LAUNCHES["dtw_banded"] == before
    np.testing.assert_array_equal(
        d.numpy(), tpl.dtw_pairs(q, lens, q, lens, DtwConfig(impl="scan")).numpy())


@pytest.mark.parametrize("impl", ["pallas", "fused"])
def test_unported_dtw_impls_raise(impl):
    # both routes are ported: on CPU tensors they run their kernel's plain
    # version and raise only on what the TPU kernel refuses (a slope; a
    # band for "fused"), never NotImplementedError
    q = torch.zeros((1, 10, 39))
    lens = torch.ones((1,), dtype=torch.int32)
    ok = DtwConfig(impl=impl, band_frac=None)
    assert tpl.dtw_pairs(q, lens, q, lens, ok).shape == (1, 1)
    with pytest.raises(ValueError, match="slope"):
        tpl.dtw_pairs(q, lens, q, lens, dataclasses.replace(ok, slope="itakura"))


def test_default_device_is_the_card():
    rec = KnnDtwRecognizer(PipelineConfig())
    assert rec.device.type == "cuda"
    if torch.cuda.is_available():
        return
    # no card: the first tensor moved to the default device raises, with
    # no fallback to the CPU
    for call in (lambda: rec.enroll("one", BANK["one"]),
                 lambda: tpl.pad_signals(QUERIES[:1], 32000),
                 lambda: tpl.extract_signals(QUERIES[:1], PipelineConfig()),
                 lambda: tfe.make_matrices(FrontendConfig())):
        with pytest.raises((AssertionError, RuntimeError)):
            call()


def test_unported_recognizer_options_raise(port_rec):
    # mesh= is ported (tests/test_torch_mesh_models.py): a non-mesh is a TypeError
    with pytest.raises(TypeError, match="DeviceMesh"):
        KnnDtwRecognizer(PipelineConfig(), device="cpu", mesh=object())
    assert port_rec.classify_connected([]) == []
    # condense is ported (tests/test_torch_align.py holds it to JAX's)
    rec = KnnDtwRecognizer.from_arrays(np.stack(port_rec._bank_feats),
                                       port_rec._bank_lens, port_rec._bank_label_ids,
                                       port_rec.labels, PipelineConfig(), device="cpu")
    rec.condense("medoid")
    assert rec._bank_label_ids == sorted(set(port_rec._bank_label_ids))
    with pytest.raises(ValueError, match="unknown matcher"):
        KnnDtwRecognizer(PipelineConfig(), device="cpu", matcher="bogus")
    cfg = dataclasses.replace(PipelineConfig(), dtw=DtwConfig(impl="bogus"))
    rec = KnnDtwRecognizer(cfg, device="cpu")
    rec.enroll("one", BANK["one"])
    with pytest.raises(ValueError, match="impl"):
        rec.classify_batch(QUERIES[:1])
