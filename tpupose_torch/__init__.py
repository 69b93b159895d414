"""PyTorch + CUDA port of ``tpupose`` for NVIDIA Hopper GPUs.

The JAX package ``tpupose`` stays the reference; this package mirrors its
module names (``models``, ``ops``, ``detectors``, ``data``, ``train``,
``utils``, ``weights``, ``quant``, ``evaluation``, ``native``) and is
checked against it by ``tests/test_torch_*.py``.  It imports ``torch`` and nothing of ``jax`` or
of ``tpupose``: what it shares with the JAX package (the pose schema,
``InferenceConfig`` and ``TrainConfig``, the weight files' layer names, the
data pipeline's host code) it keeps as its own copy.

Hand-written Hopper kernels live in ``csrc/`` and are built with ``nvcc`` at
first use (see ``tpupose_torch/ops/_cuda_build.py``).
"""
