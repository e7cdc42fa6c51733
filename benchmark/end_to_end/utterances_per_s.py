"""Utterances whose labels reached the host in the window, over the
window's seconds (from its start to the end of its last request): all
the work over all the time."""


def read(win):
    if "utterances" not in win["work"] or win["window_s"] <= 0:
        return None
    return win["work"]["utterances"] / win["window_s"]
