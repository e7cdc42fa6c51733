"""Host staging: host ms a request in the program's ``dsp.h2d`` spans
(``pipeline.pad_signals``'s two blocking copies to the card), summed over
the traced window's requests: the host's view of the copies that
``h2d_ms_per_req`` reads on the device (``program_log.py``)."""

from benchmark import program_log


def read(rec):
    return program_log.span_ms_per_req(rec, "dsp.h2d")
