"""PyTorch/CUDA port of the Multi-Mode Inference Engine for CNNs.

A second package beside the JAX reference `repro`, with the same layout
(`core/`, `engine/`, `kernels/`, `models/`). The engine's "cuda" backend
runs hand-written Hopper kernels (`csrc/*.cu`, built with `nvcc` at first
use); "torch" and "ref" run the same ops in plain PyTorch. Entry points run
on the GPU unless the caller asks for the CPU. Importing the package needs
neither a GPU, `nvcc` nor JAX.
"""
