"""Data-parallel EM and decode in real gloo worlds of 4 and 2 processes:
``parallel/em.py:em_step_sharded``, ``fit_word(mesh=)``,
``GmmHmmRecognizer.fit(mesh=)`` (batched: words over 'bank', utterances
over 'data'; and the per-word loop), the GMM-HMM's data-parallel decode
(``GmmHmmRecognizer(mesh=)``), ``ops/streaming.shard_streams`` and the
cross-process helpers of ``parallel/multihost.py``.

Every path runs on the meshes (1, 4), (2, 2), (4, 1) in one 4-rank world
and (1, 2) in a 2-rank world (``tests/torch_mesh_rank.py``).

Tolerances: one E-step and M-step from the same parameters on seeded
features (as tests/test_torch_gmm_hmm.py makes them) against JAX's step at
rtol/atol 1e-4, as tests/test_torch_gmm_hmm.py holds the single-device
step: JAX's single-device step on every shape, JAX's ``em_step_sharded``
on the (2, 2) mesh (each JAX mesh shape compiles anew, ~13 s here).
``fit_word(mesh=)`` on those features against the port's single-device
fit at rtol/atol 1e-4.  The recognizer's whole fits on speech features
against the port's single-device fits at rtol/atol 1e-2, the tolerance of
tests/test_torch_gmm_hmm.py for the recognizer's fit: only the order of
the summed statistics differs, and E[x^2] - mean^2 of MFCCs amplifies it
(measured up to 1.25e-3 in a log-variance after three iterations where
the utterances split over 'data', 0 where they do not: ROADMAP.md queue
3); labels equal.  Decode scores on the same parameters against JAX's
mesh decode at rtol 1e-4 and labels equal (tests/test_torch_gmm_hmm.py);
streams against the port's
single-process run at rtol 1e-5 with flags and indices equal, and
against JAX's sharded streams at the tolerances of
tests/test_torch_streaming.py (MFCC rtol/atol 2e-4, energy rtol 1e-4).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsp_tpu import parallel as jpar
from dsp_tpu.config import HmmConfig as JHmmConfig
from dsp_tpu.config import PipelineConfig as JPipelineConfig
from dsp_tpu.models import gmm_hmm as jg
from dsp_tpu.ops import frontend as jfe
from dsp_tpu.ops import streaming as jst

from dsp_tpu_torch.config import FrontendConfig, HmmConfig, PipelineConfig
from dsp_tpu_torch.io import synth_word
from dsp_tpu_torch.models import gmm_hmm as pg
from dsp_tpu_torch.ops import frontend as tfe
from dsp_tpu_torch.ops import streaming as tst

import torch_mesh_rank as ranks

SHAPES4 = [(1, 4), (2, 2), (4, 1)]
SHAPES2 = [(1, 2)]
SHAPES = SHAPES4 + SHAPES2
LABELS = ["zero", "one", "two", "three"]       # 4 words: every bank axis divides
TRAIN = {lab: [synth_word(lab, i) for i in range(4)] for lab in LABELS}
QUERIES = [synth_word(LABELS[i % 4], 40 + i) for i in range(6)]
HMM = HmmConfig(n_states=3, n_mix=2, n_iter=3)
JHMM = JHmmConfig(n_states=3, n_mix=2, n_iter=3)
CHUNK = 1600
FIELDS = pg.HmmParams._fields


def _em_inputs():
    """Seeded features as tests/test_torch_gmm_hmm.py:_feats makes them, and
    JAX's initial parameters for them."""
    rng = np.random.default_rng(3)
    feats = rng.standard_normal((8, 40, 8)).astype(np.float32)
    feats[:, :20] += 1.5
    lengths = rng.integers(4, 41, size=8).astype(np.int32)
    lengths[0] = 40
    for i, length in enumerate(lengths):
        feats[i, length:] = 0.0
    params = jg.init_params(jnp.asarray(feats), jnp.asarray(lengths), JHMM,
                            jax.random.PRNGKey(0))
    return feats, lengths, [np.asarray(a) for a in params]


FEATS, FLENS, P0 = _em_inputs()


def _streams(n_chunks=16):
    """8 streams of 1.6 s: noise, a word from 0.3 s, then silence."""
    rng = np.random.default_rng(7)
    sig = 0.002 * rng.standard_normal((8, n_chunks * CHUNK)).astype(np.float32)
    for s in range(8):
        w = synth_word(LABELS[s % 4], 60 + s)[: 8 * CHUNK]
        sig[s, 4800:4800 + len(w)] += w
    return sig.reshape(8, n_chunks, CHUNK)


CHUNKS = _streams()


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
def jax_hmm():
    rec = jg.GmmHmmRecognizer(JPipelineConfig(), JHMM)
    rec.fit(TRAIN)
    return rec


@pytest.fixture(scope="module")
def worlds(jax_hmm, tmp_path_factory):
    inp = {"labels": np.asarray(json.dumps(LABELS)), "feats": FEATS,
           "jlabels": np.asarray(json.dumps(jax_hmm.labels)),
           "flens": FLENS, "chunks": CHUNKS, "chunk_len": np.asarray(CHUNK),
           **{f"p0_{f}": a for f, a in zip(FIELDS, P0)},
           **{f"jp_{f}": np.asarray(a) for f, a in zip(FIELDS, jax_hmm.params)},
           **ranks.pack_signals("queries", QUERIES)}
    for i, lab in enumerate(LABELS):
        inp.update(ranks.pack_signals(f"train{i}", TRAIN[lab]))
    out = {}
    for world, shapes in ((4, SHAPES4), (2, SHAPES2)):
        got = ranks.run_world(tmp_path_factory.mktemp(f"w{world}"), world, "em",
                              dict(inp, shapes=np.asarray(shapes)))
        for nd, nb in shapes:
            out[(nd, nb)] = got
    return out


def _get(worlds, shape, key, same_on_every_rank=True):
    per_rank = worlds[shape]
    k = f"{shape[0]}x{shape[1]}:{key}"
    if same_on_every_rank:
        for r in per_rank[1:]:
            np.testing.assert_array_equal(r[k], per_rank[0][k], err_msg=k)
    return per_rank[0][k]


def _params(worlds, shape, prefix):
    return [_get(worlds, shape, f"{prefix}_{f}") for f in FIELDS]


def _assert_params(got, want, tol):
    """Each field at rtol = atol = ``tol`` (tests/test_torch_gmm_hmm.py's
    measure: |got - want| against 1 + |want|)."""
    for f, g, w in zip(FIELDS, got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=tol, atol=tol, err_msg=f)


@pytest.fixture(scope="module")
def jax_step():
    """JAX's single-device step from P0 (the sharded step's reference on
    every shape) and its sharded step on a (2, 2) mesh (each mesh shape
    compiles anew, ~13 s here)."""
    single = jg._em_iteration(jnp.asarray(FEATS), jnp.asarray(FLENS),
                              jg.HmmParams(*map(jnp.asarray, P0)), JHMM)
    mesh = jpar.make_mesh(2, 2)
    fd, ld = jpar.shard_queries(mesh, FEATS, FLENS)
    pd = jg.HmmParams(*(jpar.replicate(mesh, a) for a in P0))
    return single, jpar.em_step_sharded(mesh, fd, ld, pd, JHMM)


@pytest.mark.parametrize("shape", SHAPES)
def test_em_step_sharded_matches_jax(worlds, jax_step, shape):
    got, got_ll = _params(worlds, shape, "em"), _get(worlds, shape, "em_ll")
    for want, want_ll in jax_step[:1] + (jax_step[1:] if shape == (2, 2) else ()):
        _assert_params(got, want, 1e-4)
        np.testing.assert_allclose(got_ll, float(want_ll), rtol=1e-4)
    # and the port's single-device step from the same parameters
    p0 = pg.params_from_numpy(tuple(P0), "cpu")
    single, ll = pg._em_iteration(torch.from_numpy(FEATS), torch.from_numpy(FLENS),
                                  p0, HMM)
    _assert_params(got, [a.numpy() for a in single], 1e-5)
    np.testing.assert_allclose(got_ll, float(ll), rtol=1e-6)


@pytest.mark.parametrize("shape", SHAPES)
def test_fit_word_mesh_matches_single_device(worlds, shape):
    want = pg.fit_word(torch.from_numpy(FEATS), torch.from_numpy(FLENS), HMM, seed=3)
    _assert_params(_params(worlds, shape, "fw"), [a.numpy() for a in want], 1e-4)


@pytest.mark.parametrize("batched", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_fit_mesh_matches_single_device(worlds, shape, batched):
    rec = pg.GmmHmmRecognizer(PipelineConfig(), HMM, device="cpu")
    rec.fit(TRAIN, batched=batched)
    got = _params(worlds, shape, f"fit{int(batched)}")
    gap = max(float(np.max(np.abs(g - w.numpy()) / (1 + np.abs(w.numpy()))))
              for g, w in zip(got, rec.params))
    print(f"fit(mesh={shape}, batched={batched}): largest gap {gap:.2e}")
    _assert_params(got, [a.numpy() for a in rec.params], 1e-2)
    got = list(_get(worlds, shape, f"fit{int(batched)}_labels"))
    assert got == rec.classify_batch(QUERIES)


@pytest.mark.parametrize("shape", SHAPES)
def test_hmm_mesh_decode_matches_jax(worlds, jax_hmm, shape):
    labels = list(_get(worlds, shape, "dec"))
    scores = _get(worlds, shape, "dec_s")
    jax_hmm.mesh = jpar.make_mesh(*shape)
    try:
        want, want_s = jax_hmm.classify_batch(QUERIES, return_scores=True)
    finally:
        jax_hmm.mesh = None
    assert labels == want == [LABELS[i % 4] for i in range(6)]
    np.testing.assert_allclose(scores, want_s, rtol=1e-4)
    single = pg.GmmHmmRecognizer(PipelineConfig(), HMM, device="cpu")
    single.labels = jax_hmm.labels
    single.params = pg.params_from_numpy(
        tuple(np.asarray(a) for a in jax_hmm.params), "cpu")
    want, want_s = single.classify_batch(QUERIES, return_scores=True)
    assert labels == want
    np.testing.assert_allclose(scores, want_s, rtol=1e-5)


def _assembled(worlds, shape):
    """The streams' outputs assembled from each data shard's ranks."""
    per_rank = worlds[shape]
    tag = f"{shape[0]}x{shape[1]}"
    shards = {}
    for r in per_rank:
        d = int(r[f"{tag}:st_coord"][0])
        got = {f: r[f"{tag}:st_{f}"] for f in tst.ChunkOutput._fields}
        if d in shards:                       # ranks of one data row agree
            for f in got:
                np.testing.assert_array_equal(got[f], shards[d][f])
        shards[d] = got
    assert sorted(shards) == list(range(shape[0]))
    return {f: np.concatenate([shards[d][f] for d in range(shape[0])])
            for f in tst.ChunkOutput._fields}


@pytest.mark.parametrize("shape", SHAPES)
def test_shard_streams(worlds, shape):
    got = _assembled(worlds, shape)
    fcfg = FrontendConfig()
    state = tst.init_state_batch(8, fcfg, CHUNK, "cpu")
    mats = tfe.make_matrices(fcfg, "cpu")
    rows = []
    for c in range(CHUNKS.shape[1]):
        state, o = tst.process_chunk_batch(state, torch.from_numpy(CHUNKS[:, c]),
                                           mats, fcfg, chunk_len=CHUNK)
        rows.append(o)
    for f in tst.ChunkOutput._fields:
        want = np.stack([getattr(o, f).numpy() for o in rows], 1)
        if want.dtype.kind == "f":
            np.testing.assert_allclose(got[f], want, rtol=1e-5, atol=1e-6, err_msg=f)
        else:
            np.testing.assert_array_equal(got[f], want, err_msg=f)
    assert got["utt_end"].any()


def test_shard_streams_matches_jax_sharded_streams(worlds):
    shape = (2, 2)
    got = _assembled(worlds, shape)
    jcfg = JPipelineConfig()
    mesh = jpar.make_mesh(*shape)
    state, chunks = jst.shard_streams(
        mesh, jst.init_state_batch(8, jcfg.frontend, CHUNK), CHUNKS)
    mats = jfe.make_matrices(jcfg.frontend)
    rows = []
    for c in range(CHUNKS.shape[1]):
        state, o = jst.process_chunk_batch(state, chunks[:, c], mats, jcfg.frontend,
                                           jcfg.vad, CHUNK)
        rows.append(o)
    for f in tst.ChunkOutput._fields:
        want = np.stack([np.asarray(getattr(o, f)) for o in rows], 1)
        if f == "mfcc":
            np.testing.assert_allclose(got[f], want, rtol=2e-4, atol=2e-4, err_msg=f)
        elif f == "energy":
            np.testing.assert_allclose(got[f], want, rtol=1e-4, err_msg=f)
        else:
            np.testing.assert_array_equal(got[f], want, err_msg=f)


@pytest.mark.parametrize("world", [4, 2])
def test_multihost_across_ranks(worlds, world):
    """Exact min/max, all_hosts_agree, the mean and is_primary over real
    processes."""
    per_rank = worlds[(2, 2) if world == 4 else (1, 2)]
    for rank, r in enumerate(per_rank):
        assert tuple(r["mh_minmax"]) == (0.25, world - 1 + 0.25)
        assert bool(r["mh_agree_same"]) and not bool(r["mh_agree_diff"])
        assert float(r["mh_mean"]) == np.float32(sum(range(world)) / world)
        assert bool(r["mh_primary"]) == (rank == 0)
        assert str(r["mh_backend"]) == "gloo"
