"""Benchmarks of the port (counterpart of the repository's ``benchmarks/``).

``sparse_kernel_lab``: the sparse kernel lab on the card,
``python -m photon_ml_tpu_torch.benchmarks.sparse_kernel_lab [n] [k] [d]``.
"""
