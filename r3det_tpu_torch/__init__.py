"""r3det_tpu_torch: R3Det / rotated RetinaNet serving, training and DOTA
evaluation in PyTorch, with hand-written CUDA kernels for Hopper
(``csrc/``).

The port of ``r3det_tpu`` (JAX/Pallas on TPU). It mirrors that package's
layout (``core/``, ``datasets/``, ``models/``, ``ops/``, ``parallel/``,
``utils/``, ``tools/``) and keeps its public tensor layouts (NHWC images,
``(B, H, W, A*C)`` head maps), so every function can be held against its
JAX counterpart. It imports ``torch`` and numpy, never ``jax``, and needs
no OpenCV.
"""
