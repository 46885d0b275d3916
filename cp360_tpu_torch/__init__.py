"""cp360_tpu_torch — the PyTorch/CUDA port of cp360_tpu for one NVIDIA H100.

CP-360 weakly-supervised 360° video saliency: cube-padded ResNet CAMs ->
cube-padded ConvLSTM -> equirectangular saliency.  Plain tensor code is
PyTorch; the JAX package's Pallas kernels are hand-written CUDA kernels for
Hopper (``csrc/``), each beside a plain torch version that runs for CPU
tensors and serves as the test oracle.  Layouts at public functions are the
JAX package's: NHWC activations, HWIO kernels, faces ordered B D F L R T.

This package imports nothing of ``jax`` or ``cp360_tpu``.
"""
