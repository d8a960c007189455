"""Hand-written CUDA kernels for the solver's hot paths, each beside its plain
torch version (used for CPU tensors and as the reference on the card)."""
