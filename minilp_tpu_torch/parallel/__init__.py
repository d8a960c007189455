"""Batched scenario solving: many independent LPs per call (`batched.py`) and
heterogeneous batches bucketed by size (`scheduling.py`)."""
