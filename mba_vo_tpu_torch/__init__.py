"""PyTorch/CUDA port of the blur-aware visual odometry tracker.

A second package beside ``mba_vo_tpu`` (the JAX reference). It imports
``torch`` and numpy, never ``jax`` and never ``mba_vo_tpu``; the layout
mirrors the reference (``core/``, ``ops/``, ``solver/``, ``tracker/``,
``utils/``, ``data/``) so each module's counterpart is easy to find.

The windowed bilinear sampler (``ops.window_sampling.window_bilinear``) runs
a hand-written CUDA kernel (``csrc/window_bilinear.cu``) on CUDA tensors and
its plain PyTorch version on CPU tensors.
"""
