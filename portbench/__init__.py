"""The benchmark of ``repro_torch``, the PyTorch and CUDA port, on NVIDIA
H100 cards: MuST/LSMS's KKR solves and PARSEC's subspace sweeps run
through the port's BLAS offload.  ``python3 portbench/run.py --workload
<cell> --seed <n> --seconds <s> --trace <0|1>`` runs one cell of
``BENCHMARK.json`` once and prints its result as the last line of its
standard output.  Nothing here imports ``jax`` or the JAX package."""
