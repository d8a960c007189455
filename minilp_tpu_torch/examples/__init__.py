"""The JAX package's examples (`examples/`), ported: branch-and-cut TSP on
the incremental API (`tsp`), batched scenario solving (`scenario_batch`)
and the Netlib-style MPS runner (`netlib_runner`).  Each runs as
``python -m minilp_tpu_torch.examples.<name>``."""
