"""Matcher parity: the port's time normalisation, LTW and cascade matchers,
length-bucketed classify, host readouts and DTW routing against the JAX
package, on the same features (extracted once by the JAX package).

Tolerances: time normalisation rtol 1e-5 / atol 1e-6 (one interpolation
per element); LTW distances rtol 1e-5 (one fp32 GEMM); cascade and
bucketed DTW distances rtol 1e-5 (the scan's row sums in another order);
ids, candidates and every host readout exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsp_tpu import pipeline as jpl
from dsp_tpu.config import DtwConfig as JDtwConfig
from dsp_tpu.config import PipelineConfig as JPipelineConfig
from dsp_tpu.io.dataset import DIGITS
from dsp_tpu.ops import frontend as jfe

from dsp_tpu_torch import pipeline as tpl
from dsp_tpu_torch.config import DtwConfig, PipelineConfig
from dsp_tpu_torch.io import synth_word
from dsp_tpu_torch.kernels import _build
from dsp_tpu_torch.kernels import dtw_fused as kfu
from dsp_tpu_torch.kernels import dtw_pallas as kwf
from dsp_tpu_torch.ops import frontend as tfe

LABELS = DIGITS[:4]


def _dists_close(got, want, rtol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert ((got >= 1e20) == (want >= 1e20)).all()
    fin = want < 1e20
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol)


@pytest.fixture(scope="module")
def feats():
    """(JAX Features, port Features) of mixed-length queries and a bank of
    LABELS x 2 templates, extracted once by the JAX package."""
    rng = np.random.default_rng(0)
    cfg = JPipelineConfig()
    mats = jfe.make_matrices(cfg.frontend)
    bank_sigs = [synth_word(lab, i) for lab in LABELS for i in range(2)]
    q_sigs = []
    for i, lab in enumerate(LABELS * 3):
        x = synth_word(lab, 100 + i)
        q_sigs.append(x[: int(len(x) * rng.uniform(0.3, 1.0))])

    def extract(sigs):
        x, n = jpl.pad_signals(sigs, cfg.max_samples)
        f = jpl.extract_features(x, n, mats, cfg)
        jf = jpl.Features(f.feats, f.length)
        return jf, tpl.Features(torch.from_numpy(np.array(f.feats)),
                                torch.from_numpy(np.array(f.length)))

    ids = np.repeat(np.arange(len(LABELS)), 2).astype(np.int32)
    return extract(q_sigs), extract(bank_sigs), (jnp.asarray(ids), torch.from_numpy(ids))


@pytest.mark.parametrize("length,target", [(13, 8), (16, 16), (1, 8), (20, 33)])
def test_time_normalize_matches_jax(length, target):
    rng = np.random.default_rng(length)
    x = rng.standard_normal((2, 20, 5)).astype(np.float32)
    lens = np.array([length, max(1, length - 3)], np.int32)
    got = tfe.time_normalize(torch.from_numpy(x), torch.from_numpy(lens), target)
    want = jax.vmap(lambda f, n: jfe.time_normalize(f, n, target))(
        jnp.asarray(x), jnp.asarray(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("target_len", [64, 48])
def test_ltw_matches_jax(feats, target_len):
    (jq, tq), (jb, tb), (jids, tids) = feats
    want_ids, want_d = jpl.classify_features_ltw(jq, jb, jids, target_len)
    got_ids, got_d = tpl.classify_features_ltw(tq, tb, tids, target_len)
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
    # |q|^2 + |t|^2 - 2 q.t cancels: besides rtol 1e-5, allow a few float32
    # ulps of the expansion's magnitude (the two GEMMs sum in other orders)
    q = tfe.time_normalize(tq.feats, tq.length, target_len).flatten(1)
    t = tfe.time_normalize(tb.feats, tb.length, target_len).flatten(1)
    scale = ((q * q).sum(1)[:, None] + (t * t).sum(1)[None, :]).numpy() / q.shape[1]
    err = np.abs(got_d.numpy() - np.asarray(want_d))
    assert (err <= 1e-5 * np.abs(np.asarray(want_d))
            + 4 * np.finfo(np.float32).eps * scale).all(), err.max()


@pytest.mark.parametrize("shortlist,k,kw", [(3, 1, {}), (4, 3, {}),
                                            (3, 1, {"slope": "itakura"}),
                                            (20, 1, {"max_warp_scale": None})])
def test_cascade_matches_jax(feats, shortlist, k, kw):
    (jq, tq), (jb, tb), (jids, tids) = feats
    want = jpl.classify_features_cascade(
        jq, jb, jids, shortlist, k, n_labels=len(LABELS),
        cfg=JPipelineConfig(dtw=JDtwConfig(**kw)))
    got = tpl.classify_features_cascade(
        tq, tb, tids, shortlist, k, n_labels=len(LABELS),
        cfg=PipelineConfig(dtw=DtwConfig(**kw)))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    _dists_close(got[1].numpy(), want[1])


def test_cascade_rerank_is_dtw_of_the_candidates(feats):
    _, (_, tb), (_, tids) = feats
    (_, tq), _, _ = feats
    _, d, cand = tpl.classify_features_cascade(tq, tb, tids, 5)
    full = tpl.dtw_pairs(tq.feats, tq.length, tb.feats, tb.length, DtwConfig(impl="scan"))
    _dists_close(d.numpy(), torch.take_along_dim(full, cand, dim=1).numpy())


@pytest.mark.parametrize("k", [1, 3])
def test_bucketed_matches_unbucketed_and_jax(feats, k):
    (jq, tq), (jb, tb), (jids, tids) = feats
    cfg = PipelineConfig()
    got_ids, got_d = tpl.classify_features_bucketed(tq, tb, tids, n_labels=len(LABELS),
                                                    k=k, cfg=cfg, pad_to=4)
    ids, d = tpl.classify_features(tq, tb, tids, n_labels=len(LABELS), k=k, cfg=cfg)
    np.testing.assert_array_equal(got_ids, ids.numpy())
    np.testing.assert_array_equal(got_d, d.numpy())
    want_ids, want_d = jpl.classify_features_bucketed(
        jq, jb, jids, n_labels=len(LABELS), k=k, cfg=JPipelineConfig(), pad_to=4)
    np.testing.assert_array_equal(got_ids, np.asarray(want_ids))
    _dists_close(got_d, want_d)
    assert len(set(np.minimum(tq.length.numpy(), 198) > 99)) == 2   # mixed buckets


def test_bucketed_requires_a_long_enough_bank(feats):
    (_, tq), (_, tb), (_, tids) = feats
    short = tpl.Features(tb.feats[:, :50], tb.length.clamp(max=50))
    with pytest.raises(ValueError, match="bucketed classify requires bank U"):
        tpl.classify_features_bucketed(tq, short, tids, cfg=PipelineConfig())


def test_host_readouts_match_jax():
    rng = np.random.default_rng(1)
    scores = rng.uniform(0, 5, size=(6, 4))
    scores[1, :2] = 1e30
    scores[2] = 2.5e27
    scores[3] = 2.0
    for n, hb in ((3, False), (2, True), (9, False)):
        assert (tpl.nbest_from_scores(scores, LABELS, n, higher_better=hb)
                == jpl.nbest_from_scores(scores, LABELS, n, higher_better=hb))
    for a, b in ((["a", "b", "c"], ["a", "c"]), ([], ["x"]), (list("kitten"),
                                                             list("sitting"))):
        assert tpl.edit_distance(a, b) == jpl.edit_distance(a, b)
    corpus = {"one": [1, 2, 3], "two": [4, 5], "three": [6]}

    def classify(sigs):
        return ["one" if s < 4 else "two" for s in sigs]

    assert tpl.evaluate_corpus(classify, corpus) == jpl.evaluate_corpus(classify, corpus)


def test_dtw_pairs_routes_fused_and_pallas_on_cpu_tensors(feats):
    (_, tq), (_, tb), _ = feats
    args = (tq.feats, tq.length, tb.feats, tb.length)
    k5, k4 = _build.LAUNCHES["dtw_wavefront"], _build.LAUNCHES["dtw_fused"]
    for kw in ({}, {"max_warp_scale": None}, {"band_frac": None}):
        _dists_close(tpl.dtw_pairs(*args, DtwConfig(impl="pallas", **kw)).numpy(),
                     tpl.dtw_pairs(*args, DtwConfig(impl="scan", **kw)).numpy())
    unbanded = DtwConfig(band_frac=None)
    got = tpl.dtw_pairs(*args, DtwConfig(impl="fused", band_frac=None)).numpy()
    want = tpl.dtw_pairs(*args, unbanded).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    # plain versions only
    assert (_build.LAUNCHES["dtw_wavefront"], _build.LAUNCHES["dtw_fused"]) == (k5, k4)
    with pytest.raises(ValueError, match="unbanded"):
        tpl.dtw_pairs(*args, DtwConfig(impl="fused"))
