"""Host staging: the times a request the host waits on the card, from
the program's ``host_syncs`` counter over the traced window: the two
blocking copies of ``pipeline.pad_signals`` and the two readbacks of
``KnnDtwRecognizer.classify_batch`` (labels, distances), 4 a request of
``host256`` (``program_log.py``)."""

from benchmark import program_log


def read(rec):
    n = program_log.counted(rec, "host_syncs")
    if n is None:
        return None
    return n / rec["requests"]
