"""wast3d_tpu_torch: the PyTorch + CUDA port of `wast3d_tpu`.

Module names mirror the JAX package, so each module's counterpart is easy
to find. The port imports torch, numpy and the standard library only; it
never imports JAX or any module of `wast3d_tpu`.

Every entry point takes `device=None`, which means CUDA (see `device.py`).
Kernels are built on their first call on a CUDA tensor (`_build.py`), never
at import, so every module imports on a machine without a GPU or `nvcc`.
"""
