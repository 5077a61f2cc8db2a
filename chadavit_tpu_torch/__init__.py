"""chadavit_tpu_torch — the ChAdaViT embedding path in PyTorch, with hand-written
CUDA kernels for an NVIDIA H100.

The port of ``chadavit_tpu`` (JAX on a TPU), module for module. It imports
torch and numpy and nothing of the JAX package. On CUDA tensors the encoder
layer and the attention run as the kernels in ``csrc/``; on CPU tensors they
run as their plain PyTorch versions.
"""
