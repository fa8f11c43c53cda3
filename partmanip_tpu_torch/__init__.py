"""partmanip_tpu_torch — the PyTorch / CUDA port of ``partmanip_tpu``.

Same sub-package layout and function names as the JAX package
(``ops/ sim/ envs/ models/ algos/ utils/``), so every module here has its
counterpart there.  Plain tensor code is PyTorch; the fused physics inner
step is a hand-written CUDA kernel (``csrc/fused_inner_step.cu``, wrapped by
``sim/fused.py``).  The package imports ``torch``, ``numpy``, ``yaml`` and
the standard library only — never ``jax`` and nothing of ``partmanip_tpu``.

Entry points run on the GPU unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
