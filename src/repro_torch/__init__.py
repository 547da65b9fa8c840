"""PyTorch/CUDA port of ``repro``: TwinSearch new-user onboarding for
neighbourhood-based collaborative filtering, on an NVIDIA H100.

The layout mirrors ``repro`` (``core/``, ``kernels/<name>/``, ``serving/``,
``training/``, ``data/``).  The kernels on the serving path are written by
hand in CUDA C++ (``csrc/``), built with ``nvcc`` for ``sm_90a`` at first
use and bound with ``ctypes``; on CPU tensors each wrapper runs its plain
PyTorch version instead.  The package imports neither ``jax`` nor
``repro``.
"""
