"""Device (the whole connected-digit request): a request's float32
operations over its share of the traced window at 67 TFLOP/s, in
percent.  The operations are the front end's and both topologies'
emissions from shapes, and the level DP's at the strings' lengths
(``connected_roofline.py``), whatever kernels compute them."""

from benchmark import connected_roofline, roofline


def read(rec):
    if rec["requests"] <= 0 or rec["window_s"] <= 0 or "transitions" not in rec:
        return None
    flops = sum(connected_roofline.request_flops(rec, lens) for lens in rec["request_lens"])
    return 100.0 * flops / rec["window_s"] / roofline.PEAK_FP32_FLOPS
