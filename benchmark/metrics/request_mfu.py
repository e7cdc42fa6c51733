"""Device (the whole request): a request's float32 operations over its
share of the traced window at 67 TFLOP/s, in percent.  The operations are
the front end's, counted from shapes at the configuration's widths, and
the DTW's cells at the inputs' lengths (``roofline.py``), whatever
kernels compute them."""

from benchmark import roofline


def read(rec):
    if rec["requests"] <= 0 or rec["window_s"] <= 0:
        return None
    t, f = rec["t_max"], rec["n_feats"]
    table = roofline.cell_table(t, t, rec["band_frac"], rec["max_warp_scale"], rec["device"])
    flops = sum(roofline.dtw_flops(roofline.dtw_cells(q, rec["bank_lens"], table), f)
                for q in rec["request_lens"])
    flops += rec["requests"] * roofline.frontend_flops(
        rec["batch"], rec["n_samples"], t, rec["frame_len"], rec["hop"], rec["n_fft"],
        rec["n_mels"], rec["n_mfcc"])
    return 100.0 * flops / rec["window_s"] / roofline.PEAK_FP32_FLOPS
