"""Host staging: device ms a request of host-to-device copies (the padded
clips ``classify_batch`` copies to the card), from the trace's
``Memcpy HtoD`` events."""

COPY = "HtoD"


def read(rec):
    copies = [e.dur for e in rec["events"] if e.cat == "gpu_memcpy" and COPY in e.name]
    if not copies:
        return None
    return sum(copies) / 1e3 / rec["requests"]
