"""Kernels: the DTW work's least time on the card over the DTW kernels'
device time, in percent.  The least time is the larger of the DP cells
inside each pair's lengths (at the endpoint detector's lengths), band
and window at 2F + 3 operations over 67 TFLOP/s, and the features,
lengths and distances once over 3.35 TB/s (``roofline.py``)."""

from benchmark import roofline

DTW_KERNELS = ("dtw_banded", "dtw_fused", "dtw_wavefront")


def read(rec):
    us = sum(e.dur for e in rec["events"]
             if e.cat == "kernel" and any(k in e.name for k in DTW_KERNELS))
    if not us:
        return None
    t, f = rec["t_max"], rec["n_feats"]
    table = roofline.cell_table(t, t, rec["band_frac"], rec["max_warp_scale"], rec["device"])
    k = len(rec["bank_lens"])
    least = sum(roofline.least_seconds(
        roofline.dtw_flops(roofline.dtw_cells(q, rec["bank_lens"], table), f),
        roofline.dtw_bytes(len(q), t, k, t, f)) for q in rec["request_lens"])
    return 100.0 * least / (us / 1e6)
