"""Hand-written Hopper kernels (`csrc/*.cu`), their plain PyTorch versions,
the launch glue (`ops`) and the oracles (`ref`)."""
