"""Front end (launches): device kernels a request, counted in the trace,
so that kernels replayed from a CUDA graph count too."""


def read(rec):
    n = sum(1 for e in rec["events"] if e.cat == "kernel")
    if not n:
        return None
    return n / rec["requests"]
