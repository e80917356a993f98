"""LAPACK-tier solver subsystem (paper §4.2's real workload shape).

The port's counterpart of ``repro/solvers``.  The paper's headline wins
come from applications whose hot loops are *LAPACK* calls (MuST/LSMS's
``zgetrf``/``zgetrs``, Cholesky, dense eigensolves), whose panel updates
are the gemm/trsm/syr2k stream SCILIB-Accel offloads:

* :mod:`repro_torch.solvers.drivers`: span-wrapped factorization and
  solve drivers over :mod:`repro_torch.core.lapack`
  (getrf/getrs/gesv/potrf/potrs) and :mod:`repro_torch.solvers.eigen`
  (syev).  Each driver opens a *solver span* on the active runtime: the
  factor buffer is pinned on the device tier for the span's lifetime,
  every inner BLAS call is stamped with the span's ``solver_id``, and
  per-solver statistics (calls, panel share, moved bytes, seconds) go to
  the runtime report.
* :mod:`repro_torch.solvers.eigen`: blocked one-stage Hermitian
  tridiagonalization (latrd panels + syr2k/her2k updates), a host
  tridiagonal eigensolve and a compact-WY back-transform.
* :mod:`repro_torch.solvers.intercept`: trampolines over
  ``torch.linalg.cholesky/solve/lu_factor/lu_solve/solve_triangular/
  eigh/eigvalsh`` and ``torch.cholesky_solve``, enabled per session by
  ``OffloadConfig.lapack`` (``SCILIB_LAPACK=1``); block size by
  ``lapack_nb`` (``SCILIB_LAPACK_NB``).
"""
from repro_torch.solvers.drivers import (gesv, getrf, getrs, potrf, potrs,
                                         syev)

__all__ = ["getrf", "getrs", "gesv", "potrf", "potrs", "syev"]
