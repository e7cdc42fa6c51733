"""Device: the share of the traced window, in percent, in which no
kernel, copy or memset ran on the card (the union of the trace's device
intervals against the window's length)."""


def read(rec):
    if rec["window_s"] <= 0 or not rec["events"]:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
