"""rr_ms: milliseconds of CheFSI's Rayleigh-Ritz step per step (the
dgemm Hs = Psi_o^T HPsi_o, eigh and the dgemm Psi_o Q), by the
benchmark's CUDA events around them; none where no span ran."""


def read(w):
    spans = w.spans_ms.get("rr")
    return sum(spans) / len(spans) if spans else None
