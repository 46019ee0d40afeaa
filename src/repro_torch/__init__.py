"""PyTorch and CUDA port of the neural-graphics system, for NVIDIA Hopper.

It sits beside the JAX package ``repro`` and keeps its layout: ``core/``
(encodings, MLPs, fields, rendering, the frame pipeline), ``kernels/``
(each TPU kernel's hand-written CUDA counterpart, its wrapper and its plain
PyTorch version), ``csrc/`` (the CUDA sources), ``data/``, ``obs/`` and
``serve/``. It imports ``torch`` and ``numpy``, never ``jax`` and nothing
of ``repro``.

Entry points (``init_field``, ``render_frame``, ``RenderEngine``) run on
CUDA unless the caller passes ``device="cpu"``; without a GPU they raise.
"""
