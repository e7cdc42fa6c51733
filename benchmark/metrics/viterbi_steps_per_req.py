"""Matcher (GMM-HMM): the decode's time steps the host issues a request,
from the program's ``viterbi_steps`` counter over the traced window
(T - 1 a ``viterbi_score`` call: 197 a request at T = 198)."""

from benchmark import program_log


def read(rec):
    n = program_log.counted(rec, "viterbi_steps")
    if n is None:
        return None
    return n / rec["requests"]
