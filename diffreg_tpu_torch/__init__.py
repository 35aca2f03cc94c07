"""diffreg_tpu_torch — the PyTorch/CUDA port of diffreg_tpu for one NVIDIA H100.

The layout mirrors the JAX package module by module. The port's main path
is 3DMatch DDIM registration (``eval.register.register``); its two kernels
(KPConv and masked attention) are CUDA C++ in ``csrc/``, built with nvcc for
sm_90a at first use. Entry points run on "cuda" unless the caller passes
``device="cpu"``, where every kernel's plain PyTorch version runs instead.
"""
