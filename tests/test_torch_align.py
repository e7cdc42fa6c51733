"""DTW alignment, medoid, DBA and ``KnnDtwRecognizer.condense`` in the
port against the JAX package, on the CPU.

Alignment paths and step counts are held equal element for element (the
same DP and tie rules; the two min-plus scans sum in other tree orders,
which moves no path at these seeded inputs) and distances at rtol 1e-5
(measured 9.3e-8).  ``_dp_table``'s end cell over (la+lb) is held bit-equal
to the port's ``dtw_batch`` (the LOCKSTEP rule).  DBA centers at atol
1e-5 (measured 0: the JAX segment sum against a one-hot GEMM).
The condense tests enroll the bank in JAX and load it through the
``.npz``; labels are held equal and the condensed bank's ``.npz`` must
load in JAX and classify as the port does."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsp_tpu.config import DtwConfig as JDtwConfig
from dsp_tpu.config import PipelineConfig as JPipelineConfig
from dsp_tpu.golden import dtw as gdtw
from dsp_tpu.models.knn_dtw import KnnDtwRecognizer as JKnnDtwRecognizer
from dsp_tpu.ops import align as jalign

from dsp_tpu_torch.config import DtwConfig, PipelineConfig
from dsp_tpu_torch.io import synth_word
from dsp_tpu_torch.models.knn_dtw import KnnDtwRecognizer
from dsp_tpu_torch.ops import align as talign
from dsp_tpu_torch.ops import dtw as tdtw

LABELS = ["zero", "one", "two"]
CONFIGS = {
    "unbanded": {"band_frac": None},
    "banded": {"band_frac": 0.3},
    "itakura": {"band_frac": None, "slope": "itakura"},
    "itakura_banded": {"band_frac": 0.3, "slope": "itakura"},
}
# (len_a, len_b) of a [30, F] x [26, F] pair: whole, masked, and a ratio
# past 2 where Itakura has no admissible path (an all-BIG walk)
LENGTHS = [(30, 26), (22, 17), (12, 20), (25, 9)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the DP loops are hundreds of small ops, which
    crawl when parallel test workers oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(seed=0, t=30, u=26, f=4):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((t, f)).astype(np.float32),
            rng.standard_normal((u, f)).astype(np.float32))


def _recordings(seed=1, n=5, t=30, f=4):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, t, f)).astype(np.float32),
            rng.integers(15, t + 1, n).astype(np.int32))


@pytest.mark.parametrize("lens", LENGTHS)
@pytest.mark.parametrize("name", list(CONFIGS))
def test_dtw_alignment_matches_jax(name, lens):
    a, b = _pair()
    la, lb = lens
    kw = CONFIGS[name]
    jd, jpi, jpj, jn = jalign.dtw_alignment(jnp.asarray(a), jnp.asarray(b),
                                            jnp.asarray(la), jnp.asarray(lb),
                                            JDtwConfig(**kw))
    d, pi, pj, n = talign.dtw_alignment(torch.from_numpy(a), torch.from_numpy(b),
                                        la, lb, DtwConfig(**kw))
    assert pi.shape == pj.shape == (30 + 26 - 1,)
    np.testing.assert_array_equal(pi, np.asarray(jpi))
    np.testing.assert_array_equal(pj, np.asarray(jpj))
    assert n == int(jn)
    if float(jd) < 1e20:
        np.testing.assert_allclose(float(d), float(jd), rtol=1e-5)
    else:
        assert float(d) >= 1e20


@pytest.mark.parametrize("slope", [None, "itakura"])
def test_dtw_alignment_matches_golden_path(slope):
    a, b = _pair(seed=3)
    cfg = DtwConfig(band_frac=None, slope=slope)
    _, pi, pj, n = talign.dtw_alignment(torch.from_numpy(a), torch.from_numpy(b),
                                        cfg=cfg)
    _, path = gdtw.dtw_distance(a, b, JDtwConfig(band_frac=None, slope=slope),
                                return_path=True)
    want = np.asarray(path)[::-1]                   # golden is start-first
    np.testing.assert_array_equal(np.stack([pi[:n], pj[:n]], axis=1), want)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_dp_table_end_cell_bit_equal_to_dtw_batch(name):
    q, ql = _recordings(seed=2, n=3)
    bank, bl = _recordings(seed=4, n=4)
    cfg = DtwConfig(**CONFIGS[name])
    want = tdtw.dtw_batch(torch.from_numpy(q), torch.from_numpy(ql),
                          torch.from_numpy(bank), torch.from_numpy(bl), cfg)
    la = torch.from_numpy(ql).to(torch.int64)[:, None].expand(3, 4)
    lb = torch.from_numpy(bl).to(torch.int64)[None, :].expand(3, 4)
    cost = tdtw.masked_cost(torch.from_numpy(q), la[:, 0], torch.from_numpy(bank),
                            lb[0], cfg)
    table = (talign._dp_tables_itakura(cost)[0] if cfg.slope
             else talign._dp_table(cost))
    end = table[torch.arange(3)[:, None], torch.arange(4)[None, :], la - 1, lb - 1]
    assert torch.equal(end / (la + lb).to(torch.float32), want)
    # and the single pair of dtw_distance is dtw_batch's entry
    assert torch.equal(tdtw.dtw_distance(torch.from_numpy(q[1]), torch.from_numpy(bank[2]),
                                         int(ql[1]), int(bl[2]), cfg), want[1, 2])


@pytest.mark.parametrize("slope", [None, "itakura"])
def test_alignment_pairs_equal_single_pairs(slope):
    feats, lens = _recordings(seed=5)
    a, b = _pair(seed=6)
    cfg = DtwConfig(band_frac=None, slope=slope)
    n = len(lens)
    d, pi, pj, steps = talign.dtw_alignment_pairs(
        torch.from_numpy(a[None, :26]).expand(n, -1, -1), torch.full((n,), 26),
        torch.from_numpy(feats), torch.from_numpy(lens), cfg)
    for i in range(n):
        d1, pi1, pj1, n1 = talign.dtw_alignment(torch.from_numpy(a[:26]),
                                                torch.from_numpy(feats[i]), 26,
                                                int(lens[i]), cfg)
        assert torch.equal(d[i], d1)
        np.testing.assert_array_equal(pi[i], pi1)
        np.testing.assert_array_equal(pj[i], pj1)
        assert steps[i] == n1


@pytest.mark.parametrize("name", ["unbanded", "banded", "itakura"])
def test_medoid_matches_jax(name):
    feats, lens = _recordings(seed=7, n=6)
    kw = CONFIGS[name]
    want = int(jalign.medoid(jnp.asarray(feats), jnp.asarray(lens), JDtwConfig(**kw)))
    assert talign.medoid(torch.from_numpy(feats), torch.from_numpy(lens),
                         DtwConfig(**kw)) == want


@pytest.mark.parametrize("n_iter", [1, 3])
@pytest.mark.parametrize("name", ["unbanded", "itakura"])
def test_dba_average_matches_jax(name, n_iter):
    feats, lens = _recordings(seed=8)
    kw = CONFIGS[name]
    c = 2
    want = np.asarray(jalign.dba_average(
        jnp.asarray(feats), jnp.asarray(lens), jnp.asarray(feats[c]),
        jnp.asarray(lens[c]), n_iter, JDtwConfig(**kw)))
    got = talign.dba_average(torch.from_numpy(feats), torch.from_numpy(lens),
                             torch.from_numpy(feats[c]), int(lens[c]), n_iter,
                             DtwConfig(**kw)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert not got[lens[c]:].any()


@pytest.fixture(scope="module")
def bank_path(tmp_path_factory):
    """A 3-word bank of 3 templates a word, enrolled by the JAX package."""
    jrec = JKnnDtwRecognizer(JPipelineConfig())
    for lab in LABELS:
        jrec.enroll(lab, [synth_word(lab, i) for i in range(3)])
    path = str(tmp_path_factory.mktemp("bank") / "bank.npz")
    jrec.save(path)
    return path


QUERIES = [synth_word(lab, 20 + i) for i, lab in enumerate(LABELS * 3)]


@pytest.mark.parametrize("method", ["medoid", "dba"])
def test_condense_matches_jax_and_round_trips(method, bank_path, tmp_path):
    jrec = JKnnDtwRecognizer.load(bank_path, JPipelineConfig())
    rec = KnnDtwRecognizer.load(bank_path, PipelineConfig(), device="cpu")
    rec.device_bank()                                   # cached, then cleared
    jrec.condense(method)
    rec.condense(method)
    assert rec._device_bank is None
    assert rec._bank_label_ids == jrec._bank_label_ids == [0, 1, 2]
    assert rec._bank_lens == jrec._bank_lens
    np.testing.assert_allclose(np.stack(rec._bank_feats), np.stack(jrec._bank_feats),
                               rtol=0, atol=1e-5)
    corpus = {lab: [synth_word(lab, 20 + i) for i in range(3)] for lab in LABELS}
    assert rec.classify_batch(QUERIES) == jrec.classify_batch(QUERIES)
    assert rec.evaluate(corpus)["accuracy"] == jrec.evaluate(corpus)["accuracy"]
    path = str(tmp_path / "condensed.npz")
    rec.save(path)
    back = JKnnDtwRecognizer.load(path, JPipelineConfig())
    assert back.n_templates == 3
    assert back.classify_batch(QUERIES) == rec.classify_batch(QUERIES)


def test_condense_aligns_unbanded_with_the_slope(bank_path, monkeypatch):
    rec = KnnDtwRecognizer.load(
        bank_path, dataclasses.replace(PipelineConfig(), dtw=DtwConfig(slope="itakura")),
        device="cpu")
    seen = []
    real = talign.dba_average

    def spy(feats, lens, center, len_c, n_iter, cfg):
        seen.append(cfg)
        return real(feats, lens, center, len_c, n_iter, cfg)

    monkeypatch.setattr(talign, "dba_average", spy)
    rec.condense("dba", n_iter=1)
    assert seen and all(c.band_frac is None and c.slope == "itakura" for c in seen)
    with pytest.raises(ValueError, match="condense method"):
        rec.condense("mean")
