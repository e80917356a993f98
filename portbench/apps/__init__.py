"""The applications' steps through ``repro_torch``'s public surface, one
module per ``app`` that a configuration names.  Each holds a frozen copy
of the application's loop, written as an unmodified code calls BLAS and
LAPACK: inputs born on the host, one session, the public symbols."""
