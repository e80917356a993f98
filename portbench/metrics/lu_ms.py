"""lu_ms: milliseconds of ``lu_factor`` + ``lu_solve`` per step, by the
benchmark's CUDA events around them; none where no span ran."""


def read(w):
    spans = w.spans_ms.get("lu")
    return sum(spans) / len(spans) if spans else None
