"""Front end: device ms a request of every kernel that is not a DTW
kernel: the endpoint detector, the MFCC chain and the deltas
(``pipeline.extract_features``), and also the few small ops of the
argmin and the label gather, which the trace cannot tell apart."""

DTW_KERNELS = ("dtw_banded", "dtw_fused", "dtw_wavefront")


def read(rec):
    ms = [e.dur for e in rec["events"]
          if e.cat == "kernel" and not any(k in e.name for k in DTW_KERNELS)]
    if not ms:
        return None
    return sum(ms) / 1e3 / rec["requests"]
