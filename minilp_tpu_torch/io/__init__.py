"""Problem I/O: the MPS reader and writer (PyTorch port's copy of
`minilp_tpu/io/`)."""
