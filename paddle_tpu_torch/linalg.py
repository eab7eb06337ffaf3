"""paddle.linalg: the op table's linear-algebra ops under their linalg
names (port of ``paddle_tpu/linalg.py``; ``inv`` is ``inverse``)."""
from .ops.registry import OPS as _OPS

__all__ = ["cholesky", "norm", "cond", "cov", "corrcoef", "inv", "eig",
           "eigvals", "multi_dot", "matrix_rank", "svd", "qr", "lu",
           "lu_unpack", "matrix_power", "det", "slogdet", "eigh",
           "eigvalsh", "pinv", "solve", "cholesky_solve",
           "triangular_solve", "lstsq", "cholesky_inverse", "vector_norm",
           "matrix_norm", "householder_product"]

_ALIASES = {"inv": "inverse"}

for _name in __all__:
    globals()[_name] = _OPS[_ALIASES.get(_name, _name)]
del _name
