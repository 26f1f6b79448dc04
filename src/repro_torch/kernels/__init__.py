"""Hand-written Hopper kernels and their plain PyTorch twins.

``ref`` holds the plain version of every op, ``ops`` is the dispatch
point: CUDA tensors go to the kernel, CPU tensors to the twin.
"""
