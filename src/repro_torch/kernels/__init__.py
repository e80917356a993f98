"""Hand-written Hopper kernels of the port and their plain versions.

``gemm``/``trsm``/``syrk``/``attention``/``decode_attention`` wrap the
CUDA kernels in ``csrc/`` (built at first use by ``compat``);
``split_gemm`` binds the split-precision passes to the gemm kernel;
``ops`` is what the BLAS surface and the model stack call; ``ref`` holds
the plain PyTorch versions the kernels are checked against.  Importing
this package builds nothing.
"""
from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]
