"""PyTorch + CUDA port of ``tpupose`` for NVIDIA Hopper GPUs.

The JAX package ``tpupose`` stays the reference; this package mirrors its
module names (``models``, ``ops``, ``detectors``, ``utils``, ``quant``) and
is checked against it by ``tests/test_torch_*.py``.  It imports ``torch`` and never
``jax``: the only ``tpupose`` modules it reads are the numpy-only
``tpupose.config`` and ``tpupose.weights.chainer_npz``.

Hand-written Hopper kernels live in ``csrc/`` and are built with ``nvcc`` at
first use (see ``tpupose_torch/ops/_cuda_build.py``).
"""
