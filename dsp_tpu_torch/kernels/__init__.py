"""Wrappers of the port's CUDA kernels, each beside its plain version.

Nothing here builds or loads a kernel at import; ``_build.lib()`` does so
at the first launch on a CUDA tensor.
"""
