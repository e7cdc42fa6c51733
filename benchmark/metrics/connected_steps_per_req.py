"""Matcher (connected GMM-HMM): the level DP's frame steps a request,
from the program's ``connected_steps`` counter over the traced window
(L x T a ``recognize_level_batch`` call: 9 x 598 = 5,382 a request of
``aurora2-connected``)."""

from benchmark import program_log


def read(rec):
    n = program_log.counted(rec, "connected_steps")
    if n is None:
        return None
    return n / rec["requests"]
