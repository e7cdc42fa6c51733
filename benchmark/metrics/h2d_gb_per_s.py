"""Host staging: the bandwidth of the copies to the card, in GB/s
(1e9 bytes a second): the bytes the program counted in ``h2d_bytes``
over the traced window (``pipeline.pad_signals``: the padded clips and
their lengths, 256 x 16,000 x 4 + 256 x 4 = 16,385,024 B a request of
``host256``) over the summed device us of the trace's ``Memcpy HtoD``
events in the window (bytes / us / 1e3)."""

from benchmark import program_log

COPY = "HtoD"


def read(rec):
    n_bytes = program_log.counted(rec, "h2d_bytes")
    us = sum(e.dur for e in rec["events"] if e.cat == "gpu_memcpy" and COPY in e.name)
    if not n_bytes or us <= 0:
        return None
    return n_bytes / us / 1e3
