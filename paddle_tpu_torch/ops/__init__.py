"""Operators of the port: rope (plain torch) and the hand-written CUDA
kernels under ``ops.kernels``."""
