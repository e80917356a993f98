"""blas_roofline: percent of the least time the traced steps'
application-level BLAS calls could take on one H100 (each call's
max(operations / 67 TFLOP/s, bytes / 3.35 TB/s), portbench.counts) over
the device time of the kernels they launched, copies left out (the
profiler's trace)."""


def read(w):
    p = w.profile
    if p is None or p.blas_kernel_s <= 0 or p.blas_bound_s <= 0:
        return None
    return 100.0 * p.blas_bound_s / p.blas_kernel_s
