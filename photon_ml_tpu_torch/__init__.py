"""photon_ml_tpu_torch: the PyTorch/CUDA port of ``photon_ml_tpu``.

The module layout mirrors ``photon_ml_tpu`` so each module's counterpart is
found under the same path. Plain tensor code is PyTorch; every Pallas TPU
kernel on a ported path is a CUDA kernel written for Hopper (``sm_90a``),
built from ``kernels/csrc`` at first use. The package imports neither
``jax`` nor ``photon_ml_tpu``: ``interop`` and the shared Avro model files
are the bridges between the two packages.

Ported so far: GLM scoring (``cli.score.run_scoring`` with
``model_kind="glm"``) with the ``ell_matvec`` kernel, and GLM training
(``cli.train.run_glm_training``, TRON and L-BFGS) with the
``ell_scatter_add``, ``fused_vgc`` and ``fused_hvp`` kernels.
"""

__version__ = "0.1.0"
