"""Matcher: device ms a request of the DTW kernels (kernel 1,
``csrc/dtw_banded.cu``, on this path; the other DTW kernels of the
program where a route takes them)."""

DTW_KERNELS = ("dtw_banded", "dtw_fused", "dtw_wavefront")


def read(rec):
    ms = [e.dur for e in rec["events"]
          if e.cat == "kernel" and any(k in e.name for k in DTW_KERNELS)]
    if not ms:
        return None
    return sum(ms) / 1e3 / rec["requests"]
