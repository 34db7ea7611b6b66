"""PyTorch/CUDA port of ``trilinos_tpu`` for an NVIDIA H100.

Plain tensor code is PyTorch; the JAX package's Pallas kernels on the
ported path are CUDA C++ kernels under ``csrc/``, built at first use.
Entry points place tensors on ``device=`` — ``None`` means the CUDA card
and raises without one; the tests pass ``device="cpu"``.

float32 matrix products stay in full float32 (TF32 off), the counterpart
of the JAX package's ``precision=HIGHEST`` pin on its solver GEMMs.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.set_float32_matmul_precision("highest")
