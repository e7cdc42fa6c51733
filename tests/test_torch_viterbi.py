"""The port's log-space lattice ops (``dsp_tpu_torch/ops/viterbi.py``) against
the JAX package's scans (``dsp_tpu/ops/viterbi.py``) and the numpy oracle
(``dsp_tpu/golden/hmm.py``) on the same seeded inputs.

Scores at rtol 1e-5 (the same recursion in float32: each step is one max
or one logsumexp and one add, so the two agree to rounding); decode paths
exactly (first-maximum argmax on both sides).  The oracle runs in float64
on the truncated sequences and is held at rtol 1e-5 as well.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsp_tpu import golden
from dsp_tpu.ops import viterbi as jvit
from dsp_tpu_torch.ops import viterbi as tvit

RTOL = 1e-5


def _random_hmm(rng, s, lead=()):
    log_pi = np.log(rng.dirichlet(np.ones(s), size=lead or None))
    log_a = np.log(rng.dirichlet(np.ones(s), size=(*lead, s)))
    return log_pi.astype(np.float32), log_a.astype(np.float32)


def _left_to_right(s):
    """A left-to-right model with NEG_INF entries, as GMM-HMMs use."""
    log_pi = np.full(s, -1e30, np.float32)
    log_pi[0] = 0.0
    log_a = np.full((s, s), -1e30, np.float32)
    for i in range(s):
        log_a[i, i] = np.log(0.6)
        if i + 1 < s:
            log_a[i, i + 1] = np.log(0.4)
    log_a[-1, -1] = 0.0
    return log_pi, log_a


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("model", ["random", "left_to_right"])
@pytest.mark.parametrize("s,t", [(5, 23), (3, 1), (4, 60)])
def test_score_decode_forward_match_jax_and_golden(model, s, t):
    rng = np.random.default_rng(s * 100 + t)
    log_pi, log_a = _random_hmm(rng, s) if model == "random" else _left_to_right(s)
    log_b = rng.standard_normal((t, s)).astype(np.float32)
    want_ll, want_path = golden.viterbi_log(log_pi.astype(np.float64),
                                            log_a.astype(np.float64),
                                            log_b.astype(np.float64))
    j_ll, j_path = jvit.viterbi_decode(jnp.asarray(log_pi), jnp.asarray(log_a),
                                       jnp.asarray(log_b))
    got_ll, got_path = tvit.viterbi_decode(_t(log_pi), _t(log_a), _t(log_b))
    assert got_path.shape == (t,) and got_path.dtype == torch.int64
    np.testing.assert_array_equal(got_path.numpy(), np.asarray(j_path))
    np.testing.assert_array_equal(got_path.numpy(), want_path)
    np.testing.assert_allclose(float(got_ll), float(j_ll), rtol=RTOL)
    np.testing.assert_allclose(float(got_ll), want_ll, rtol=RTOL)

    score = tvit.viterbi_score(_t(log_pi), _t(log_a), _t(log_b))
    np.testing.assert_allclose(float(score), float(jvit.viterbi_score(
        jnp.asarray(log_pi), jnp.asarray(log_a), jnp.asarray(log_b))), rtol=RTOL)
    assert float(score) == float(got_ll)      # the same max-product recursion

    fwd = tvit.forward_score(_t(log_pi), _t(log_a), _t(log_b))
    np.testing.assert_allclose(float(fwd), float(jvit.forward_score(
        jnp.asarray(log_pi), jnp.asarray(log_a), jnp.asarray(log_b))), rtol=RTOL)
    np.testing.assert_allclose(float(fwd), golden.forward_log(
        log_pi.astype(np.float64), log_a.astype(np.float64),
        log_b.astype(np.float64)), rtol=RTOL)


def test_batched_words_and_ragged_lengths():
    """[B utterances, W word models] in the leading dims of one loop, as
    score_words calls it (tests/test_viterbi.py's batched case)."""
    rng = np.random.default_rng(3)
    s, t, b, w = 3, 20, 4, 5
    log_pi, log_a = _random_hmm(rng, s, (w,))                 # [W, S], [W, S, S]
    log_b = rng.standard_normal((t, b, w, s)).astype(np.float32)
    lengths = rng.integers(1, t + 1, size=b).astype(np.int32)
    lengths[0] = t
    args_j = (jnp.asarray(log_pi)[None], jnp.asarray(log_a)[None],
              jnp.asarray(log_b), jnp.asarray(lengths)[:, None])
    args_t = (_t(log_pi)[None], _t(log_a)[None], _t(log_b), _t(lengths)[:, None])
    for fn_t, fn_j, oracle in ((tvit.viterbi_score, jvit.viterbi_score,
                                lambda *a: golden.viterbi_log(*a)[0]),
                               (tvit.forward_score, jvit.forward_score,
                                golden.forward_log)):
        got = fn_t(*args_t).numpy()
        assert got.shape == (b, w)
        np.testing.assert_allclose(got, np.asarray(fn_j(*args_j)), rtol=RTOL)
        for i in range(b):
            for j in range(w):
                want = oracle(log_pi[j].astype(np.float64), log_a[j].astype(np.float64),
                              log_b[: lengths[i], i, j].astype(np.float64))
                np.testing.assert_allclose(got[i, j], want, rtol=RTOL)


def test_batched_decode_equals_jax_vmap_with_ragged_lengths():
    """The port's decode over a leading batch [N, T, S] against the JAX
    package's single-sequence decode under vmap (em_suff_stats' use): paths
    equal, constant past each length (identity backpointers), scores equal
    to the oracle's on the truncated sequence."""
    import jax

    rng = np.random.default_rng(4)
    s, t, n = 4, 30, 6
    log_pi, log_a = _left_to_right(s)
    log_b = rng.standard_normal((n, t, s)).astype(np.float32) * 3
    lengths = np.asarray([t, 1, 2, 17, 29, 8], np.int32)
    j_ll, j_paths = jax.vmap(lambda lb, L: jvit.viterbi_decode(
        jnp.asarray(log_pi), jnp.asarray(log_a), lb, L))(jnp.asarray(log_b),
                                                          jnp.asarray(lengths))
    got_ll, got_paths = tvit.viterbi_decode(_t(log_pi), _t(log_a), _t(log_b),
                                            _t(lengths))
    assert got_paths.shape == (n, t)
    np.testing.assert_array_equal(got_paths.numpy(), np.asarray(j_paths))
    np.testing.assert_allclose(got_ll.numpy(), np.asarray(j_ll), rtol=RTOL)
    for i, length in enumerate(lengths):
        want_ll, want_path = golden.viterbi_log(
            log_pi.astype(np.float64), log_a.astype(np.float64),
            log_b[i, :length].astype(np.float64))
        np.testing.assert_array_equal(got_paths[i, :length].numpy(), want_path)
        assert (got_paths[i, length:] == got_paths[i, length - 1]).all()
        np.testing.assert_allclose(float(got_ll[i]), want_ll, rtol=RTOL)


def test_decode_takes_the_first_of_tied_maxima():
    """All-equal scores tie everywhere: argmax takes the lowest state, as
    jnp.argmax does, in the pointers and at the last frame."""
    s, t = 3, 5
    zeros = np.zeros((t, s), np.float32)
    log_pi, log_a = np.zeros(s, np.float32), np.zeros((s, s), np.float32)
    _, got = tvit.viterbi_decode(_t(log_pi), _t(log_a), _t(zeros))
    _, want = jvit.viterbi_decode(jnp.asarray(log_pi), jnp.asarray(log_a),
                                  jnp.asarray(zeros))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got == 0).all()
