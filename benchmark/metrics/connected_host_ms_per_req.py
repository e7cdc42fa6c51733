"""Matcher (connected GMM-HMM): host ms a request in the program's
``dsp.connected`` spans (the level DP of ``gmm_hmm.recognize_level_batch``:
one CUDA-graph replay on the card, its frame loop op by op elsewhere),
summed over the traced window's requests (``program_log.py``)."""

from benchmark import program_log


def read(rec):
    return program_log.span_ms_per_req(rec, "dsp.connected")
