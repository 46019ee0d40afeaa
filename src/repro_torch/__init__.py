"""PyTorch and CUDA port of the neural-graphics system, for NVIDIA Hopper.

It sits beside the JAX package ``repro`` and keeps its layout: ``core/``
(encodings, MLPs, fields, rendering, the frame pipeline, training),
``kernels/`` (each TPU kernel's hand-written CUDA counterpart, its wrapper
and its plain PyTorch version, and the encode's backward), ``csrc/`` (the
CUDA sources), ``data/``, ``obs/``, ``serve/``, ``train/`` (the
optimizer and the training engine), ``analysis/`` (its linter:
``python -m repro_torch.analysis``), and the LM stack's serving path:
``models/``, ``configs/`` (the ten architectures) and ``parallel/``
(the prefill and decode steps, one device). It imports ``torch`` and
``numpy``, never ``jax`` and nothing of ``repro``.

Entry points (``init_field``, ``render_frame``, ``RenderEngine``,
``train_field``, ``parallel.api.init_params``, ``make_cache``,
``launch.serve.serve_lm``) run on CUDA unless the caller passes
``device="cpu"``; without a GPU they raise.
"""
