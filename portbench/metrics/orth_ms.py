"""orth_ms: milliseconds of CheFSI's orthonormalization per step (the
Gram matrix's syrk, its Cholesky factor and the two side-R trsm), by the
benchmark's CUDA events around them; none where no span ran."""


def read(w):
    spans = w.spans_ms.get("orth")
    return sum(spans) / len(spans) if spans else None
