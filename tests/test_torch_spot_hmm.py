"""HMM keyword spotting parity: the port's ``ops/spot_hmm.py``,
``HmmSpotter`` and ``StreamingHmmSpotter`` against the JAX package.

The port runs on the JAX recognizer's own parameters and UBM (2 words,
S = 4, M = 2, tests/test_spot_hmm.py's fixture), carried across as numpy.
Tolerances, each measured on these inputs:

* ``spot_viterbi``: the same float32 adds and maxes in the same order as
  JAX's scan, so values and witnesses equal JAX's bit for bit; against the
  float64 golden oracle rtol 2e-5 / atol 1e-4 (tests/test_spot_hmm.py's
  rule), witnesses equal.
* LLR fields: witnesses equal; values rtol 1e-4 / atol 5e-3.  A readout
  subtracts two UBM prefix sums that reach ~2e4 nats on a 3.4 s stream,
  where float32's spacing is 2e-3, and the two packages' emission GEMMs
  and cumsums round apart by about that (1.98e-3 measured).
* Event scores (an LLR at one column): rtol 1e-4 / atol 2e-3; labels and
  spans equal.

Every port object lives on the CPU.
"""

import dataclasses
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_spotter import _build_stream  # noqa: E402

from dsp_tpu.config import HmmConfig as JHmmConfig  # noqa: E402
from dsp_tpu.config import PipelineConfig as JPipelineConfig  # noqa: E402
from dsp_tpu.golden import spot_hmm as gsh  # noqa: E402
from dsp_tpu.io.dataset import make_corpus  # noqa: E402
from dsp_tpu.models import gmm_hmm as jgh  # noqa: E402
from dsp_tpu.models import spotter as jspotter  # noqa: E402
from dsp_tpu.ops import spot_hmm as jsh  # noqa: E402

from dsp_tpu_torch import GmmHmmRecognizer, HmmConfig, PipelineConfig  # noqa: E402
from dsp_tpu_torch.config import FrontendConfig  # noqa: E402
from dsp_tpu_torch.models import HmmSpotter, StreamingHmmSpotter  # noqa: E402
from dsp_tpu_torch.models import gmm_hmm as pg  # noqa: E402
from dsp_tpu_torch.ops import spot_hmm as tsh  # noqa: E402

NEG_INF = gsh.NEG_INF
HCFG = dict(n_states=4, n_mix=2, n_iter=4)
LLR_TOL = dict(rtol=1e-4, atol=5e-3)
SCORE_TOL = dict(rtol=1e-4, atol=2e-3)
STREAM = _build_stream(["three", "zero", "four", "one", "five"], seed=2)[0]


def _random_lr_hmm(rng, s):
    """tests/test_spot_hmm.py's random left-right transitions."""
    stay = rng.uniform(0.3, 0.8, size=s)
    log_a = np.full((s, s), NEG_INF)
    di = np.arange(s)
    log_a[di, di] = np.log(stay)
    log_a[di[:-1], di[:-1] + 1] = np.log1p(-stay[:-1])
    log_a[s - 1, s - 1] = 0.0
    return log_a


def _np(a):
    return np.asarray(a)


@pytest.fixture(scope="module")
def jax_rec():
    rec = jgh.GmmHmmRecognizer(JPipelineConfig(), JHmmConfig(**HCFG))
    rec.fit(make_corpus(["zero", "one"], n_per_word=5, seed=0))
    return rec


def _port_of(jrec, cfg=PipelineConfig()):
    """A port recognizer on the JAX recognizer's own parameters and UBM."""
    rec = GmmHmmRecognizer(cfg, HmmConfig(**HCFG), device="cpu")
    rec.labels = list(jrec.labels)
    rec.params = pg.params_from_numpy(tuple(_np(a) for a in jrec.params), "cpu")
    rec.ubm = pg.ubm_from_numpy([_np(a) for a in jrec.ubm], "cpu")
    return rec


@pytest.fixture(scope="module")
def port_rec(jax_rec):
    return _port_of(jax_rec)


def _assert_events_close(got, want):
    assert [ev[:3] for ev in got] == [ev[:3] for ev in want], (got, want)
    np.testing.assert_allclose([ev[3] for ev in got], [ev[3] for ev in want], **SCORE_TOL)


def _feed(spotter, sig, chunk):
    n_full = len(sig) // chunk * chunk
    events = []
    for lo in range(0, n_full, chunk):
        events += spotter.feed(sig[lo:lo + chunk])
    return events + spotter.flush(sig[n_full:])


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_spot_viterbi_matches_jax_and_golden(seed):
    rng = np.random.default_rng(seed)
    u, w, s = 17, 4, 3
    log_a = np.stack([_random_lr_hmm(rng, s) for _ in range(w)]).astype(np.float32)
    logb = rng.normal(-3.0, 2.0, size=(2, u, w, s)).astype(np.float32)
    v, st = tsh.spot_viterbi(torch.from_numpy(logb), torch.from_numpy(log_a))
    assert v.shape == st.shape == (2, w, u) and st.dtype == torch.int32
    for b in range(2):          # the leading batch in place of JAX's vmap
        jv, jst = jsh.spot_viterbi(jnp.asarray(logb[b]), jnp.asarray(log_a))
        np.testing.assert_array_equal(v[b].numpy(), _np(jv))
        np.testing.assert_array_equal(st[b].numpy(), _np(jst))
        for wi in range(w):
            gv, gst = gsh.spot_viterbi_tables(log_a[wi].astype(np.float64),
                                              logb[b, :, wi].astype(np.float64))
            np.testing.assert_allclose(v[b, wi].numpy(), gv[:, -1], rtol=2e-5, atol=1e-4)
            np.testing.assert_array_equal(st[b, wi].numpy(), gst[:, -1])


def test_llr_readout_matches_jax_and_golden():
    rng = np.random.default_rng(7)
    u, s = 14, 3
    log_a = _random_lr_hmm(rng, s)
    logb = rng.normal(-2.0, 1.0, size=(u, s))
    ubm_ll = rng.normal(-3.0, 0.5, size=u)
    want_llr, want_st = gsh.spot_llr(*gsh.spot_viterbi_tables(log_a, logb), ubm_ll)
    v, st = tsh.spot_viterbi(torch.tensor(logb[None, :, None, :], dtype=torch.float32),
                             torch.tensor(log_a[None], dtype=torch.float32))
    ubm_t = torch.tensor(np.stack([ubm_ll, ubm_ll]), dtype=torch.float32)
    got = tsh._llr_readout(v.expand(2, -1, -1), st.expand(2, -1, -1), ubm_t,
                           torch.tensor([u, 9]))
    jv, jst = jsh.spot_viterbi(jnp.asarray(logb[:, None, :], jnp.float32),
                               jnp.asarray(log_a[None], jnp.float32))
    for row, n in enumerate((u, 9)):
        want_j = _np(jsh._llr_readout(jv, jst, jnp.asarray(ubm_ll, jnp.float32),
                                      jnp.asarray(n)))[0]
        np.testing.assert_allclose(got[row, 0].numpy(), want_j, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got[row, 0, :n].numpy(), want_llr[:n], rtol=2e-4, atol=1e-4)
        assert (got[row, 0, n:] == NEG_INF).all()
    np.testing.assert_array_equal(st[0, 0].numpy(), want_st)


def test_spot_hmm_batch_ragged_matches_jax(jax_rec, port_rec):
    rng = np.random.default_rng(3)
    streams = rng.normal(0.0, 3.0, size=(3, 57, 39)).astype(np.float32)
    lens = np.array([57, 50, 5], np.int32)
    jl, jst = jsh.spot_hmm_batch(jnp.asarray(streams), jnp.asarray(lens), jax_rec.params,
                                 jax_rec.ubm)
    tl, tst = tsh.spot_hmm_batch(torch.from_numpy(streams), torch.from_numpy(lens),
                                 port_rec.params, port_rec.ubm)
    assert tl.shape == tst.shape == (3, 2, 57) and tst.dtype == torch.int32
    np.testing.assert_array_equal(tst.numpy(), _np(jst))
    jl = _np(jl)
    np.testing.assert_array_equal(tl.numpy() == NEG_INF, jl == NEG_INF)
    for row, n in enumerate(lens):
        np.testing.assert_allclose(tl[row, :, :n].numpy(), jl[row, :, :n], **LLR_TOL)
        assert (tl[row, :, n:] == NEG_INF).all()
    # a stream alone gives its row of the batch
    one, one_st = tsh.spot_hmm_batch(torch.from_numpy(streams[1:2, :50]),
                                     torch.tensor([50]), port_rec.params, port_rec.ubm)
    torch.testing.assert_close(one[0], tl[1, :, :50], rtol=1e-5, atol=1e-3)
    assert torch.equal(one_st[0], tst[1, :, :50])


@pytest.mark.parametrize("chunks", [[57], [10, 20, 27], [13, 44], [8] * 7 + [1]])
def test_spot_hmm_chunk_matches_offline_and_jax(jax_rec, port_rec, chunks):
    """The streaming column update against the port's offline batch and
    against JAX's chunks of the same shapes: witnesses equal, LLRs at the
    module's tolerance (tests/test_spot_hmm.py holds JAX's chunks to its
    offline at rtol 1e-4 / atol 2e-3)."""
    rng = np.random.default_rng(3)
    u = sum(chunks)
    stream = rng.normal(0.0, 3.0, size=(u, 39)).astype(np.float32)
    off, off_st = tsh.spot_hmm_batch(torch.from_numpy(stream[None]), torch.tensor([u]),
                                     port_rec.params, port_rec.ubm)
    state = tsh.spot_hmm_init(2, 4, "cpu")
    jstate = jsh.spot_hmm_init(2, 4)
    got, jgot, lo = [], [], 0
    for c in chunks:
        part = stream[lo:lo + c]
        state, llr, st = tsh.spot_hmm_chunk(state, torch.from_numpy(part), c,
                                            port_rec.params, port_rec.ubm)
        jstate, jllr, jst = jsh.spot_hmm_chunk(jstate, jnp.asarray(part),
                                               jnp.asarray(c, jnp.int32), jax_rec.params,
                                               jax_rec.ubm)
        got.append((llr.numpy(), st.numpy()))
        jgot.append((_np(jllr), _np(jst)))
        lo += c
    llr, st = (np.concatenate(p, axis=1) for p in zip(*got))
    jllr, jst = (np.concatenate(p, axis=1) for p in zip(*jgot))
    np.testing.assert_array_equal(st, off_st[0].numpy())
    np.testing.assert_allclose(llr, off[0].numpy(), rtol=1e-4, atol=2e-3)
    np.testing.assert_array_equal(st, jst)
    np.testing.assert_allclose(llr, jllr, **LLR_TOL)
    assert int(state.n_fed) == u
    for name in ("v", "p_st", "p"):
        np.testing.assert_allclose(getattr(state, name).numpy(), _np(getattr(jstate, name)),
                                   rtol=1e-5, atol=1e-2, err_msg=name)
    np.testing.assert_array_equal(state.st.numpy(), _np(jstate.st))


def test_spot_hmm_chunk_padding_rows_ignored(port_rec):
    """Rows past ``n_valid`` (an int or an int tensor) do not advance the
    DP: a padded feed equals the exact-length feed bit for bit."""
    rng = np.random.default_rng(4)
    rows = torch.from_numpy(rng.normal(0.0, 3.0, size=(11, 39)).astype(np.float32))
    p, ubm = port_rec.params, port_rec.ubm
    s1, l1, w1 = tsh.spot_hmm_chunk(tsh.spot_hmm_init(2, 4, "cpu"), rows, 11, p, ubm)
    padded = torch.cat([rows, torch.full((5, 39), 7.7)])
    for n_valid in (11, torch.tensor(11, dtype=torch.int32)):
        s2, l2, w2 = tsh.spot_hmm_chunk(tsh.spot_hmm_init(2, 4, "cpu"), padded, n_valid,
                                        p, ubm)
        for a, b in zip(s1, s2):
            assert torch.equal(a, b)
        assert torch.equal(l1, l2[:, :11]) and torch.equal(w1, w2[:, :11])
        assert (l2[:, 11:] == NEG_INF).all()


@pytest.mark.parametrize("noise_adapt", [False, True])
def test_hmm_spotter_matches_jax(jax_rec, noise_adapt):
    """``scores`` and ``spot`` against JAX's, with the word models and the
    filler PMC-adapted to the stream's noise when ``noise_adapt`` is on."""
    rec = _port_of(jax_rec)
    rec.noise_adapt = jax_rec.noise_adapt = noise_adapt
    try:
        sig = STREAM
        if noise_adapt:
            sig = (STREAM + 0.02 * np.random.default_rng(1).standard_normal(len(STREAM))
                   ).astype(np.float32)
        short = STREAM[:20000]
        (jl, jst), (jl2, jst2) = jspotter.HmmSpotter(jax_rec).scores([sig, short])
        (tl, tst), (tl2, tst2) = HmmSpotter(rec).scores([sig, short])
        for g, gs, w, ws in ((tl, tst, jl, jst), (tl2, tst2, jl2, jst2)):
            assert g.shape == w.shape
            np.testing.assert_array_equal(gs, ws)
            np.testing.assert_allclose(g, w, **LLR_TOL)
        for thr in (-30.0, 0.0):
            want = jspotter.HmmSpotter(jax_rec, threshold=thr).spot([sig, short])
            got = HmmSpotter(rec, threshold=thr).spot([sig, short])
            assert any(got) or thr == 0.0, thr
            for g, w in zip(got, want):
                _assert_events_close(g, w)
    finally:
        jax_rec.noise_adapt = False
    assert HmmSpotter(rec).scores([]) == [] and HmmSpotter(rec).spot([]) == []


def test_streaming_hmm_spotter_matches_jax_and_offline(jax_rec, port_rec):
    """Feed/flush against JAX's streaming spotter (events and scores at the
    module's tolerance) and against the port's offline spotter by JAX's
    rule (tests/test_spot_hmm.py: labels in order, spans within 2 frames,
    scores rtol 1e-3 / atol 2e-3)."""
    thr = -30.0
    got = _feed(StreamingHmmSpotter(port_rec, chunk_len=1600, threshold=thr), STREAM, 1600)
    want = _feed(jspotter.StreamingHmmSpotter(jax_rec, chunk_len=1600, threshold=thr),
                 STREAM, 1600)
    assert got
    _assert_events_close(got, want)
    offline, = HmmSpotter(port_rec, threshold=thr).spot([STREAM])
    assert [ev[0] for ev in got] == [ev[0] for ev in offline]
    for (_, s1, e1, c1), (_, s2, e2, c2) in zip(got, offline):
        assert abs(s1 - s2) <= 2 and abs(e1 - e2) <= 2, (got, offline)
        np.testing.assert_allclose(c1, c2, rtol=1e-3, atol=2e-3)


def test_streaming_hmm_spotter_chunk_size_invariance(port_rec):
    sig = STREAM
    outs = [_feed(StreamingHmmSpotter(port_rec, chunk_len=cl, threshold=-30.0), sig, cl)
            for cl in (800, 1600)]
    assert outs[0] and [e[:3] for e in outs[0]] == [e[:3] for e in outs[1]]
    np.testing.assert_allclose([e[3] for e in outs[0]], [e[3] for e in outs[1]],
                               rtol=1e-4, atol=1e-3)
    # the same chunks through a reset spotter give the same events
    ss = StreamingHmmSpotter(port_rec, chunk_len=800, threshold=-30.0)
    _feed(ss, sig, 800)
    ss.reset()
    assert _feed(ss, sig, 800) == outs[0]


def test_spotter_errors(port_rec):
    with pytest.raises(ValueError, match="not fitted"):
        HmmSpotter(GmmHmmRecognizer(device="cpu"))
    with pytest.raises(ValueError, match="not fitted"):
        StreamingHmmSpotter(GmmHmmRecognizer(device="cpu"))
    no_ubm = GmmHmmRecognizer(device="cpu")
    no_ubm.labels, no_ubm.params = port_rec.labels, port_rec.params
    for cls in (HmmSpotter, StreamingHmmSpotter):
        with pytest.raises(ValueError, match="UBM"):
            cls(no_ubm)
    cfg = PipelineConfig()
    cmn = GmmHmmRecognizer(dataclasses.replace(
        cfg, frontend=FrontendConfig(cmn=True)), device="cpu")
    cmn.labels, cmn.params, cmn.ubm = port_rec.labels, port_rec.params, port_rec.ubm
    with pytest.raises(NotImplementedError, match="cmn"):
        StreamingHmmSpotter(cmn)
    with pytest.raises(ValueError, match="chunk of"):
        StreamingHmmSpotter(port_rec).feed(np.zeros(100, np.float32))
    cmn.noise_adapt = True
    with pytest.raises(ValueError, match="noise_adapt unavailable"):
        HmmSpotter(cmn).scores([STREAM])
