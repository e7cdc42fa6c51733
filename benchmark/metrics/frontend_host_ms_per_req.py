"""Front end: host ms a request in the program's ``dsp.frontend`` spans
(``pipeline.extract_features``: the host launching the endpoint detector,
the MFCC chain and the deltas), summed over the traced window's
requests; beside ``frontend_device_ms_per_req``, the launch time against
the device time (``program_log.py``)."""

from benchmark import program_log


def read(rec):
    return program_log.span_ms_per_req(rec, "dsp.frontend")
