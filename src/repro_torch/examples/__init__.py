"""The port's twins of the JAX package's user-facing drivers.

One module per driver of ``examples/``, each runnable as

    PYTHONPATH=src python -m repro_torch.examples.<name> [--device cpu]

and each with a ``main(argv=None) -> dict`` that prints what the
reference's driver prints and returns the numbers behind it:

* :mod:`.quickstart` — automatic BLAS offload on ordinary PyTorch code
  inside ``repro_torch.session``;
* :mod:`.must_lsms` — the LSMS KKR loop under every data-movement policy,
  then the production trace replayed on the GH200 and H100 models
  (paper Table 3);
* :mod:`.parsec_dft` — the Chebyshev-filtered subspace iteration under
  Device First-Use, then the production replay (paper Table 5);
* :mod:`.serve_offload` — the decode cache under dfu, memcopy and pinned;
* :mod:`.train_100m` — a ~100M-parameter dense LM trained with
  microbatches, remat, async checkpoints and the straggler watchdog.

Without ``--device`` each runs on the card (``cuda:0``) and raises when
there is none; ``--device cpu`` runs on the CPU.
"""
