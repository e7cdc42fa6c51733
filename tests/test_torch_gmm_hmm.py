"""The port's GMM-HMM (``dsp_tpu_torch/models/gmm_hmm.py``) against the JAX
package's (``dsp_tpu/models/gmm_hmm.py``) on the same inputs, on the CPU.

``jax.random`` bits cannot be made without jax, so every fit here starts
from JAX's own draws, handed to the port as the jitter tensors its
``init_params`` / ``fit_ubm`` / ``fit_words_batched`` take (for the
recognizer, through its ``normal_draw``).  Tolerances, each set from
what was measured here (as max |got - want| / (1 + |want|)), with
headroom:

* emissions (``gmm_loglik_flat``, ``emission_logb``, ``score_ubm``) at rtol
  1e-5 / atol 1e-4 and ``score_words`` at rtol 1e-5: the same float32
  expansion, summed in another order;
* ``init_params`` from JAX's draw at 1e-5 (measured 1.5e-7);
* one E-step and M-step from the same parameters at rtol/atol 1e-4:
  segmental statistics 1.5e-6 and parameters 1.8e-6, Baum-Welch
  statistics 3.8e-5 and parameters 1.6e-5 (its occupancies are exp of
  sums of alphas and betas);
* whole fits from the same draws on seeded features: ``fit_ubm`` at 1e-5
  (measured 2.1e-7), ``fit_words_batched`` at 1e-3 (measured 2.1e-6
  segmental, 7.4e-5 Baum-Welch, 9.3e-7 MAP);
* the recognizer's fit, each package from its own features (which differ
  by up to 2.1e-4): parameters at rtol/atol 1e-2 (measured up to 2.3e-3
  absolute in the means and log-variances after five hard-alignment
  iterations), labels equal;
* the recognizer on the same parameters: scores at rtol 1e-4 (measured
  1.5e-5, the features' difference summed over ~150 frames), the
  rejection threshold at rtol 1e-4 (measured 5.2e-5); labels, rejection
  decisions and n-best labels equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsp_tpu.config import HmmConfig as JHmmConfig, PipelineConfig as JPipelineConfig
from dsp_tpu.models import gmm_hmm as jg
from dsp_tpu.models.knn_dtw import REJECT as JREJECT
from dsp_tpu_torch import GmmHmmRecognizer
from dsp_tpu_torch.config import HmmConfig, PipelineConfig
from dsp_tpu_torch.io import synth_word
from dsp_tpu_torch.models import gmm_hmm as pg
from dsp_tpu_torch.models.knn_dtw import REJECT

HCFG = dict(n_states=4, n_mix=2, n_iter=5)          # tests/test_gmm_hmm.py:13
LABELS = ["zero", "one", "two"]
OOV = ["papa", "quebec"]
TRAIN = {lab: [synth_word(lab, i) for i in range(4)] for lab in LABELS}
QUERIES = ([synth_word(lab, 50 + i) for lab in LABELS for i in range(3)]
           + [synth_word(w, 7) for w in OOV])
WANT = [lab for lab in LABELS for _ in range(3)]


def _np(a):
    return np.array(a, dtype=np.asarray(a).dtype)


def _t(a):
    return torch.from_numpy(_np(a))


def _jax_normal(shape, seed):
    return np.array(jax.random.normal(jax.random.PRNGKey(int(seed)), tuple(shape)))


def _jax_draw(shape, seed, device="cpu"):
    """The port's normal_draw with JAX's bits: what jax.random.PRNGKey(seed)
    gives for ``shape`` (the JAX fit's keys, gmm_hmm.py:478 and :564)."""
    return torch.from_numpy(_jax_normal(shape, seed)).to(device)


def _random_params(rng, lead, s, m, f):
    log_pi = np.full((*lead, s), -1e30, np.float32)
    log_pi[..., 0] = 0.0
    log_a = np.asarray(jg._lr_log_a(jnp.full((s,), 0.6), s))
    return jg.HmmParams(
        log_pi, np.broadcast_to(log_a, (*lead, s, s)).copy(),
        rng.standard_normal((*lead, s, m, f)).astype(np.float32),
        (0.3 * rng.standard_normal((*lead, s, m, f))).astype(np.float32),
        np.log(rng.dirichlet(np.ones(m), size=(*lead, s))).astype(np.float32))


def _feats(rng, n, t, f, lo=4):
    feats = rng.standard_normal((n, t, f)).astype(np.float32)
    feats[:, : t // 2] += 1.5
    lengths = rng.integers(lo, t + 1, size=n).astype(np.int32)
    lengths[0] = t
    for i, length in enumerate(lengths):
        feats[i, length:] = 0.0
    return feats, lengths


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol,
                               err_msg=what)


def _close_params(got, want, tol):
    for name in jg.HmmParams._fields:
        _close(getattr(got, name), getattr(want, name), tol, name)


# --------------------------------------------------------------- emissions
def test_emissions_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 11, 7)).astype(np.float32) * 2
    means = rng.standard_normal((6, 7)).astype(np.float32)
    log_var = (0.3 * rng.standard_normal((6, 7))).astype(np.float32)
    got = pg.gmm_loglik_flat(_t(x), _t(means), _t(log_var))
    want = jg.gmm_loglik_flat(jnp.asarray(x), jnp.asarray(means), jnp.asarray(log_var))
    assert got.shape == (3, 11, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)
    # batched parameter sets score their own rows (the training path)
    got_b = pg.gmm_loglik_flat(_t(x), _t(np.stack([means] * 3)),
                               _t(np.stack([log_var] * 3)))
    np.testing.assert_allclose(got_b.numpy(), got.numpy(), rtol=1e-6, atol=1e-5)

    p = _random_params(rng, (4,), 3, 2, 7)                       # W = 4 words
    got = pg.emission_logb(_t(x), pg.params_from_numpy(p, "cpu"))
    want = jg.emission_logb(jnp.asarray(x), jg.HmmParams(*map(jnp.asarray, p)))
    assert got.shape == (3, 11, 4, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)


def test_score_words_and_ubm_match_jax():
    rng = np.random.default_rng(1)
    w, s, m, f = 4, 3, 2, 6
    p = _random_params(rng, (w,), s, m, f)
    feats, lengths = _feats(rng, 5, 20, f)
    got = pg.score_words(_t(feats), _t(lengths), pg.params_from_numpy(p, "cpu"))
    want = jg.score_words(jnp.asarray(feats), jnp.asarray(lengths),
                          jg.HmmParams(*map(jnp.asarray, p)))
    assert got.shape == (5, w)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)

    ubm = (p.means[0, 0], p.log_var[0, 0], p.log_mix[0, 0])   # [M, F], [M, F], [M]
    got = pg.score_ubm(_t(feats), _t(lengths), tuple(map(_t, ubm)))
    want = jg.score_ubm(jnp.asarray(feats), jnp.asarray(lengths),
                        tuple(map(jnp.asarray, ubm)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)


# ---------------------------------------------------------------- training
@pytest.fixture(scope="module")
def word_data():
    """One word's seeded utterances and JAX's init from JAX's draw."""
    rng = np.random.default_rng(2)
    feats, lengths = _feats(rng, 6, 40, 8)
    cfg = JHmmConfig(**HCFG)
    params = jg.init_params(jnp.asarray(feats), jnp.asarray(lengths), cfg,
                            jax.random.PRNGKey(0))
    return feats, lengths, params


def test_init_params_from_jax_jitter(word_data):
    feats, lengths, want = word_data
    got = pg.init_params(_t(feats), _t(lengths), HmmConfig(**HCFG),
                         _jax_draw((4, 2, 8), 0))
    _close_params(got, want, 1e-5)


@pytest.mark.parametrize("mode", ["viterbi", "baum_welch"])
def test_one_em_step_matches_jax(word_data, mode):
    feats, lengths, params = word_data
    jcfg = JHmmConfig(**HCFG, train_mode=mode)
    tcfg = HmmConfig(**HCFG, train_mode=mode)
    jstats = (jg.em_suff_stats if mode == "viterbi" else jg.em_suff_stats_soft)(
        jnp.asarray(feats), jnp.asarray(lengths), params, jcfg)
    want, want_ll = jg._em_iteration(jnp.asarray(feats), jnp.asarray(lengths),
                                     params, jcfg)
    tparams = pg.params_from_numpy(tuple(map(_np, params)), "cpu")
    tstats = pg._suff_stats(_t(feats), _t(lengths), tparams, tcfg)
    for name in jg.SuffStats._fields:
        _close(getattr(tstats, name), getattr(jstats, name), 1e-4, name)
    got, got_ll = pg._em_iteration(_t(feats), _t(lengths), tparams, tcfg)
    _close_params(got, want, 1e-4)
    np.testing.assert_allclose(float(got_ll), float(want_ll), rtol=1e-5)


def test_forward_backward_matches_jax():
    rng = np.random.default_rng(10)
    s, t = 4, 12
    log_pi = np.log(rng.dirichlet(np.ones(s))).astype(np.float32)
    log_a = np.log(rng.dirichlet(np.ones(s), size=s)).astype(np.float32)
    log_b = rng.standard_normal((t, s)).astype(np.float32)
    for length in (t, 9, 1):
        want = jg._forward_backward(jnp.asarray(log_pi), jnp.asarray(log_a),
                                    jnp.asarray(log_b), jnp.asarray(length))
        got = pg._forward_backward(_t(log_pi), _t(log_a), _t(log_b),
                                   torch.tensor(length))
        for g, w, name in zip(got, want, ("alpha", "beta", "loglik")):
            _close(g, w, 1e-5, f"{name} at length {length}")


@pytest.fixture(scope="module")
def words_data():
    """W = 2 words' seeded utterances, ragged N (zero-length padding)."""
    rng = np.random.default_rng(5)
    fw, lw = [], []
    for _ in range(2):
        f, lens = _feats(rng, 4, 24, 6)
        fw.append(f)
        lw.append(lens)
    lw[1][3] = 0                                     # a padding utterance
    fw[1][3] = 0.0
    return np.stack(fw), np.stack(lw)


def test_fit_ubm_from_jax_jitter(words_data):
    feats_w, lens_w = words_data
    cfg = dict(n_states=3, n_mix=2, n_iter=3)
    feats, lens = feats_w.reshape(-1, 24, 6), lens_w.reshape(-1)
    want = jg.fit_ubm(jnp.asarray(feats), jnp.asarray(lens), JHmmConfig(**cfg),
                      jax.random.PRNGKey(3))
    got = pg.fit_ubm(_t(feats), _t(lens), HmmConfig(**cfg), _jax_draw((2, 6), 3))
    for g, w, name in zip(got, want, ("means", "log_var", "log_mix")):
        _close(g, w, 1e-5, name)


@pytest.mark.parametrize("mode,tau", [("viterbi", 0.0), ("baum_welch", 0.0),
                                      ("viterbi", 8.0)])
def test_fit_words_batched_from_jax_jitter(words_data, mode, tau):
    feats_w, lens_w = words_data
    cfg = dict(n_states=3, n_mix=2, n_iter=3, train_mode=mode, map_tau=tau)
    jcfg, tcfg = JHmmConfig(**cfg), HmmConfig(**cfg)
    seeds = np.asarray([7, 8], np.int32)
    prior_j = prior_t = None
    if tau > 0:
        ubm = jg.fit_ubm(jnp.asarray(feats_w.reshape(-1, 24, 6)),
                         jnp.asarray(lens_w.reshape(-1)), jcfg, jax.random.PRNGKey(7))
        prior_j = jg.ubm_prior(ubm, jcfg)
        prior_t = pg.ubm_prior(tuple(_t(_np(a)) for a in ubm), tcfg)
    want = jg.fit_words_batched(jnp.asarray(feats_w), jnp.asarray(lens_w),
                                jnp.asarray(seeds), jcfg, prior_j)
    jitter = torch.stack([_jax_draw((3, 2, 6), s) for s in seeds])
    got = pg.fit_words_batched(_t(feats_w), _t(lens_w), jitter, tcfg, prior_t)
    assert got.means.shape == (2, 3, 2, 6)
    _close_params(got, want, 1e-3)
    # the word axis is a batch: each word alone gives its row
    for i in range(2):
        one = pg.fit_words_batched(_t(feats_w[i:i + 1]), _t(lens_w[i:i + 1]),
                                   jitter[i:i + 1], tcfg, prior_t)
        _close_params(pg.HmmParams(*(a[0] for a in one)),
                      pg.HmmParams(*(a[i] for a in got)), 1e-5)


# -------------------------------------------------------------- recognizer
@pytest.fixture(scope="module")
def jax_rec():
    rec = jg.GmmHmmRecognizer(JPipelineConfig(), JHmmConfig(**HCFG))
    rec.fit(TRAIN)
    rec.calibrate_rejection(TRAIN)
    return rec


@pytest.fixture(scope="module")
def port_rec():
    """The port's fit of the same corpus from JAX's draws."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pg, "normal_draw", _jax_draw)
        rec = GmmHmmRecognizer(PipelineConfig(), HmmConfig(**HCFG), device="cpu")
        rec.fit(TRAIN)
    rec.calibrate_rejection(TRAIN)
    return rec


def _port_of(jrec):
    """A port recognizer on the JAX recognizer's own parameters."""
    rec = GmmHmmRecognizer(PipelineConfig(), HmmConfig(**HCFG), device="cpu")
    rec.labels = list(jrec.labels)
    rec.params = pg.params_from_numpy(tuple(map(_np, jrec.params)), "cpu")
    rec.ubm = pg.ubm_from_numpy([_np(a) for a in jrec.ubm], "cpu")
    return rec


def test_fit_from_jax_draws_matches_jax_fit(jax_rec, port_rec):
    assert port_rec.labels == jax_rec.labels == sorted(LABELS)
    _close_params(port_rec.params, jax_rec.params, 1e-2)
    for g, w in zip(port_rec.ubm, jax_rec.ubm):
        _close(g, w, 1e-2)
    assert port_rec.classify_batch(QUERIES[:9]) == jax_rec.classify_batch(QUERIES[:9]) == WANT


def test_recognizer_on_jax_params_matches(jax_rec):
    rec = _port_of(jax_rec)
    rec.calibrate_rejection(TRAIN)
    assert rec.reject_threshold == pytest.approx(jax_rec.reject_threshold, rel=1e-4)
    want, want_s = jax_rec.classify_batch(QUERIES, return_scores=True)
    got, got_s = rec.classify_batch(QUERIES, return_scores=True)
    assert got == want and got[:9] == WANT
    np.testing.assert_allclose(got_s, np.asarray(want_s), rtol=1e-4)
    want_r = jax_rec.classify_batch(QUERIES, reject=True)
    got_r = rec.classify_batch(QUERIES, reject=True)
    assert got_r == [REJECT if w == JREJECT else w for w in want_r]
    assert got_r[-len(OOV):] == [REJECT] * len(OOV)
    got_n, want_n = rec.classify_nbest(QUERIES, n=3), jax_rec.classify_nbest(QUERIES, n=3)
    assert [[h[0] for h in row] for row in got_n] == [[h[0] for h in row] for row in want_n]
    for row_g, row_w in zip(got_n, want_n):
        np.testing.assert_allclose([h[1:] for h in row_g], [h[1:] for h in row_w],
                                   rtol=1e-4, atol=1e-5)
    corpus = {lab: QUERIES[3 * i:3 * i + 3] for i, lab in enumerate(LABELS)}
    corpus.update({w: [synth_word(w, 9)] for w in OOV})
    got_e = rec.evaluate(corpus, reject=True)
    want_e = jax_rec.evaluate(corpus, reject=True)
    assert got_e["accuracy"] == want_e["accuracy"] and got_e["n"] == want_e["n"] == 11
    assert rec.recognize(QUERIES[4]) == "one"
    assert rec.recognize(QUERIES[-1], reject=True) == REJECT


def test_checkpoints_load_across_packages(jax_rec, port_rec, tmp_path):
    jpath, ppath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jax_rec.save(jpath)
    port_rec.save(ppath)
    from_jax = GmmHmmRecognizer.load(jpath, PipelineConfig(), HmmConfig(**HCFG),
                                     device="cpu")
    from_port = jg.GmmHmmRecognizer.load(ppath, JPipelineConfig(), JHmmConfig(**HCFG))
    assert from_jax.labels == jax_rec.labels and from_port.labels == port_rec.labels
    assert from_jax.reject_threshold == jax_rec.reject_threshold
    assert from_port.reject_threshold == port_rec.reject_threshold
    for name in jg.HmmParams._fields:
        np.testing.assert_array_equal(getattr(from_jax.params, name).numpy(),
                                      np.asarray(getattr(jax_rec.params, name)))
        np.testing.assert_array_equal(np.asarray(getattr(from_port.params, name)),
                                      getattr(port_rec.params, name).numpy())
    assert (from_jax.classify_batch(QUERIES, reject=True)
            == [REJECT if w == JREJECT else w
                for w in jax_rec.classify_batch(QUERIES, reject=True)])
    assert ([REJECT if w == JREJECT else w
             for w in from_port.classify_batch(QUERIES, reject=True)]
            == port_rec.classify_batch(QUERIES, reject=True))
    # a different front end is refused
    with pytest.raises(ValueError, match="different front-end"):
        GmmHmmRecognizer.load(jpath, PipelineConfig(max_samples=16000), device="cpu")


def test_fit_per_word_loop_matches_batched():
    """fit(batched=False) (one word at a time) == fit() (every word at once)
    from the same draws: the port's form of tests/test_gmm_hmm.py:206."""
    corpus = {lab: [synth_word(lab, i) for i in range(3)] for lab in LABELS}
    hmm = HmmConfig(n_states=3, n_mix=2, n_iter=3)
    loop = GmmHmmRecognizer(PipelineConfig(), hmm, device="cpu")
    loop.fit(corpus, batched=False)
    batch = GmmHmmRecognizer(PipelineConfig(), hmm, device="cpu")
    batch.fit(corpus)
    assert loop.labels == batch.labels and loop.ubm is None and batch.ubm is not None
    _close_params(loop.params, batch.params, 2e-4)
    sigs = [x for xs in corpus.values() for x in xs]
    assert loop.classify_batch(sigs) == batch.classify_batch(sigs)


def test_draws_are_seeded_and_device_free():
    a = pg.normal_draw((3, 2, 4), 5, "cpu")
    assert torch.equal(a, pg.normal_draw((3, 2, 4), 5, "cpu"))
    assert not torch.equal(a, pg.normal_draw((3, 2, 4), 6, "cpu"))
    assert a.dtype == torch.float32


def test_baum_welch_and_map_recognizers_fit_and_recognize():
    for kw in ({"train_mode": "baum_welch"}, {"map_tau": 8.0}):
        rec = GmmHmmRecognizer(PipelineConfig(), HmmConfig(**HCFG, **kw), device="cpu")
        rec.fit(TRAIN)
        assert rec.classify_batch(QUERIES[:9]) == WANT


def test_errors_and_not_ported_paths(port_rec):
    with pytest.raises(ValueError, match="not fitted"):
        GmmHmmRecognizer(device="cpu").classify_batch(QUERIES[:1])
    fresh = _port_of(port_rec)
    with pytest.raises(ValueError, match="no rejection threshold"):
        fresh.classify_batch(QUERIES[:1], reject=True)
    fresh.ubm = None
    with pytest.raises(ValueError, match="UBM"):
        fresh.classify_batch(QUERIES[:1], reject=0.0)
    with pytest.raises(ValueError, match=">= 2 words"):
        one = GmmHmmRecognizer(device="cpu")
        one.labels, one.params = ["zero"], port_rec.params
        one.calibrate_rejection({"zero": TRAIN["zero"]})
    with pytest.raises(ValueError, match="not in the model vocabulary"):
        port_rec.calibrate_rejection({"papa": QUERIES[-1:]})
    with pytest.raises(NotImplementedError, match="item 15"):
        GmmHmmRecognizer(device="cpu", mesh=object())
    with pytest.raises(NotImplementedError, match="item 15"):
        GmmHmmRecognizer(device="cpu").fit(TRAIN, mesh=object())
    with pytest.raises(NotImplementedError, match="item 15"):
        pg.fit_word(torch.zeros(1, 4, 3), torch.ones(1, dtype=torch.int32), mesh=object())
    # connected words run (tests/test_torch_connected.py holds them to JAX)
    assert port_rec.classify_connected(QUERIES[:1]) == [port_rec.classify_batch(QUERIES[:1])]
    assert port_rec.classify_connected([]) == []
    masks = port_rec.resolve_grammar({})
    assert [m.shape for m in masks] == [(3,), (3, 3), (3,)] and all(m.all() for m in masks)
    assert port_rec.classify_nbest([]) == []
