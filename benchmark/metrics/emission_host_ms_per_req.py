"""Matcher (GMM-HMM): host ms a request in the program's ``dsp.emissions``
spans (``gmm_hmm.emission_logb``: the host issuing the emission products
and the mixtures' log-sum-exp), summed over the traced window's requests
(``program_log.py``)."""

from benchmark import program_log


def read(rec):
    return program_log.span_ms_per_req(rec, "dsp.emissions")
