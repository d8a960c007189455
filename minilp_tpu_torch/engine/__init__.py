"""Solver engines of the PyTorch port: the f64 revised simplex in torch, the
host sparse engine, and the driver that routes a solve through the kernels.

Layer map position: the equivalents of the reference's L3 (simplex engine)
and L2 (basis solves); see SURVEY.md §2.
"""
