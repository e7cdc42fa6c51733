"""Host staging: host ms a request in the program's ``dsp.pad`` spans
(``pipeline.pad_signals`` filling its numpy batch), summed over the
traced window's requests (``program_log.py``)."""

from benchmark import program_log


def read(rec):
    return program_log.span_ms_per_req(rec, "dsp.pad")
