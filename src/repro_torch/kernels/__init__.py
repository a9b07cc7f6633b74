"""Hand-written Hopper kernels and their plain PyTorch versions.

Importing this package needs no ``nvcc`` and no card: a kernel is built by
``repro_torch.kernels.build`` the first time a CUDA tensor reaches it.
"""
