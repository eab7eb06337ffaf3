"""Operators of the port: rope (the plain composition, and the opt-in
route to its kernel) and the hand-written CUDA kernels under
``ops.kernels``."""
