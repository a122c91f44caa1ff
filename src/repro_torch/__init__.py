"""SEARS on PyTorch and CUDA: the storage data plane on an NVIDIA H100.

A port of the JAX package ``repro`` (the reference, which it never
imports): ``repro_torch.core`` keeps the store and control plane, and
``repro_torch.kernels`` holds the hand-written CUDA kernels with their
plain torch versions.
"""
