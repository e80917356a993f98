"""trsm_ms: milliseconds of CheFSI's two side-R triangular solves per
step, by the benchmark's CUDA events around them; none where no span
ran.  Their bound is 2 x 8.04 ms at the paper's shape, from the
operations (portbench.counts_chefsi.trsm)."""


def read(w):
    spans = w.spans_ms.get("trsm")
    return sum(spans) / len(spans) if spans else None
