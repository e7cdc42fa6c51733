"""Matcher (GMM-HMM): host ms a request in the program's ``dsp.viterbi``
spans (``ops/viterbi.py:viterbi_score`` under ``gmm_hmm.score_words``:
the host issuing the T - 1 steps of the decode), summed over the traced
window's requests (``program_log.py``)."""

from benchmark import program_log


def read(rec):
    return program_log.span_ms_per_req(rec, "dsp.viterbi")
