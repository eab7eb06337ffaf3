"""Linear algebra ops (paddle.matmul / linalg.* parity).

Port of ``paddle_tpu/ops/linalg.py``. On the card the products go to
cuBLAS and the decompositions to cuSOLVER through torch, as the
reference's go through XLA; the reference computes none of them in a
Pallas kernel. The norms are the reference's compositions
(``sqrt(sum(x * x))`` for Frobenius and the vector 2-norm), so their
gradients at 0 are the reference's too.
"""
import builtins

import torch

from ..core.tensor import dispatch
from .math import dims, jabs
from .registry import register, register_direct


@register("matmul", method=True)
def matmul(x, y, transpose_x=False, transpose_y=False):
    if transpose_x and x.dim() > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.dim() > 1:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


@register("mm", method=True)
def mm(x, y):
    return torch.matmul(x, y)


@register("bmm", method=True)
def bmm(x, y):
    return torch.matmul(x, y)


@register("dot", method=True)
def dot(x, y):
    return torch.sum(x * y, dim=-1)


@register("inner", method=True)
def inner(x, y):
    return torch.inner(x, y)


@register("outer", method=True)
def outer(x, y):
    return torch.outer(x, y)


@register("cross", method=True)
def cross(x, y, axis=-1):
    return torch.linalg.cross(x, y, dim=axis)


@register("kron")
def kron(x, y):
    return torch.kron(x, y)


@register("mv", method=True)
def mv(x, vec):
    return torch.matmul(x, vec)


@register("t", method=True)
def t(x):
    return x.permute(*reversed(range(x.dim()))) if x.dim() >= 2 else x


@register("trace", method=True)
def trace(x, offset=0, axis1=0, axis2=1):
    return torch.diagonal(x, offset, axis1, axis2).sum(-1)


def _vnorm(x, p, axis, keepdim):
    """``jnp.linalg.norm``'s vector norms, composed as jnp composes them."""
    d = dims(x, axis)
    if p == float("inf"):
        return torch.amax(jabs(x), dim=d, keepdim=keepdim)
    if p == float("-inf"):
        return torch.amin(jabs(x), dim=d, keepdim=keepdim)
    if p == 0:
        return torch.sum((x != 0).to(x.dtype), dim=d, keepdim=keepdim)
    if p == 1:
        return torch.sum(jabs(x), dim=d, keepdim=keepdim)
    if p == 2:
        return torch.sqrt(torch.sum(torch.real(x * x.conj()) if x.is_complex()
                                    else x * x, dim=d, keepdim=keepdim))
    return torch.sum(jabs(x) ** p, dim=d, keepdim=keepdim) ** (1.0 / p)


@register("norm", method=True)
def norm(x, p=None, axis=None, keepdim=False):
    if p is None:
        p = "fro" if axis is None or not isinstance(axis, int) else 2
    d = dims(x, axis)
    if p == "fro":
        return torch.sqrt(torch.sum(torch.square(x), dim=d, keepdim=keepdim))
    if p == float("inf"):
        return torch.amax(jabs(x), dim=d, keepdim=keepdim)
    if p == float("-inf"):
        return torch.amin(jabs(x), dim=d, keepdim=keepdim)
    if p == 0:
        return torch.sum((x != 0).to(x.dtype), dim=d, keepdim=keepdim)
    return torch.pow(torch.sum(torch.pow(jabs(x), p), dim=d,
                               keepdim=keepdim), 1.0 / p)


@register("dist")
def dist(x, y, p=2):
    return norm.__wrapped__(x - y, p=p)


@register("matrix_norm")
def matrix_norm(x, p="fro", axis=(-2, -1), keepdim=False):
    if p == "fro":
        return torch.sqrt(torch.sum(torch.real(x * x.conj()) if x.is_complex()
                                    else x * x, dim=tuple(axis),
                                    keepdim=keepdim))
    return torch.linalg.matrix_norm(x, ord=p, dim=tuple(axis),
                                    keepdim=keepdim)


@register("vector_norm")
def vector_norm(x, p=2, axis=None, keepdim=False):
    # axis=None: the vector norm of the flattened input (paddle's)
    if axis is None:
        out = _vnorm(x.reshape(-1), p, None, False)
        return out.reshape((1,) * x.dim()) if keepdim else out
    return _vnorm(x, p, axis, keepdim)


@register("cond")
def cond(x, p=None):
    return torch.linalg.cond(x, p)


@register("det", method=True)
def det(x):
    return torch.linalg.det(x)


@register("slogdet")
def slogdet(x):
    sign, logabs = torch.linalg.slogdet(x)
    return torch.stack([sign, logabs])


@register("inverse", method=True)
def inverse(x):
    return torch.linalg.inv(x)


@register("pinv")
def pinv(x, rcond=1e-15, hermitian=False):
    return torch.linalg.pinv(x, rtol=rcond, hermitian=hermitian)


@register("matrix_power", method=True)
def matrix_power(x, n):
    return torch.linalg.matrix_power(x, n)


@register("matrix_rank")
def matrix_rank(x, tol=None, hermitian=False):
    return torch.linalg.matrix_rank(x, rtol=tol, hermitian=hermitian)


@register("qr")
def qr(x, mode="reduced"):
    if mode == "r":
        return torch.linalg.qr(x, mode="r").R
    return tuple(torch.linalg.qr(x, mode=mode))


@register("svd")
def svd(x, full_matrices=False):
    return tuple(torch.linalg.svd(x, full_matrices=full_matrices))


@register("eig")
def eig(x):
    return tuple(torch.linalg.eig(x))


@register("eigh")
def eigh(x, UPLO="L"):
    return tuple(torch.linalg.eigh(x, UPLO=UPLO))


@register("eigvals")
def eigvals(x):
    return torch.linalg.eigvals(x)


@register("eigvalsh")
def eigvalsh(x, UPLO="L"):
    return torch.linalg.eigvalsh(x, UPLO=UPLO)


@register("cholesky", method=True)
def cholesky(x, upper=False):
    return torch.linalg.cholesky(x, upper=upper)


@register("cholesky_solve")
def cholesky_solve(x, y, upper=False):
    return torch.cholesky_solve(x, _factor(y, upper), upper=upper)


def _factor(c, upper):
    """The triangle of a Cholesky factor that the solve reads, as
    ``cho_solve`` reads it: the other one gets no gradient."""
    return torch.triu(c) if upper else torch.tril(c)


@register("solve")
def solve(x, y):
    return torch.linalg.solve(x, y)


@register("triangular_solve")
def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False):
    if transpose:
        x, upper = x.transpose(-1, -2), not upper
    return torch.linalg.solve_triangular(x, y, upper=upper,
                                         unitriangular=unitriangular)


@register("lstsq")
def lstsq(x, y, rcond=None):
    """(solution, residuals, rank, singular values), as
    ``jnp.linalg.lstsq``: residuals are the squared column norms of
    ``y - x @ solution`` when the system is full rank and tall, else
    empty."""
    sv = torch.linalg.svdvals(x)
    m, n = x.shape[-2], x.shape[-1]
    eps = torch.finfo(x.dtype).eps
    tol = (builtins.max(m, n) * eps if rcond is None else rcond) * sv.amax(
        -1, keepdim=True)
    rank = (sv > tol).sum(-1).to(torch.int32)
    sol = torch.linalg.pinv(x, rtol=(tol / sv.amax(-1, keepdim=True))
                            .squeeze(-1)) @ y
    if int(rank.min()) == n and m > n:
        r = y - x @ sol
        resid = torch.sum(r * r, dim=-2)
    else:
        resid = torch.zeros((0,), dtype=x.dtype, device=x.device)
    return sol, resid, rank, sv


@register("lu")
def lu(x, pivot=True):
    """(packed LU, pivots) with 0-based pivots, as
    ``jax.scipy.linalg.lu_factor`` gives them."""
    lu_, piv = torch.linalg.lu_factor(x, pivot=pivot)
    return lu_, piv - 1


def multi_dot(xs):
    """paddle.linalg.multi_dot(list_of_tensors)."""
    return dispatch(lambda *vs: torch.linalg.multi_dot(vs), *xs,
                    name="multi_dot")


register_direct("multi_dot", multi_dot)


@register("householder_product")
def householder_product(x, tau):
    return torch.linalg.householder_product(x, tau)


@register("corrcoef")
def corrcoef(x, rowvar=True):
    return torch.corrcoef(x if rowvar else x.transpose(-1, -2))


@register("cov")
def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None):
    return torch.cov(x if rowvar else x.transpose(-1, -2),
                     correction=1 if ddof else 0,
                     fweights=None if fweights is None else fweights.long(),
                     aweights=aweights)


def einsum(equation, *operands):
    return dispatch(lambda *vs: torch.einsum(equation, *vs), *operands,
                    name="einsum")


register_direct("einsum", einsum)


@register("einsum_impl")
def _einsum_vals(*operands, equation=None):
    return torch.einsum(equation, *operands)


# ------------------------------------------------------- linalg tail


@register("addmm", method=True)
def addmm(input, x, y, beta=1.0, alpha=1.0):  # noqa: A002
    return beta * input + alpha * (x @ y)


@register("baddbmm", method=True)
def baddbmm(input, x, y, beta=1.0, alpha=1.0):  # noqa: A002
    return beta * input + alpha * torch.matmul(x, y)


@register("vander")
def vander(x, n=None, increasing=False):
    n = x.shape[-1] if n is None else n
    powers = torch.arange(n, dtype=x.dtype, device=x.device)
    if not increasing:
        powers = powers.flip(0)
    return x.unsqueeze(-1) ** powers


@register("cdist")
def cdist(x, y, p=2.0):
    d = x[..., :, None, :] - y[..., None, :, :]
    if p == 2.0:
        return torch.sqrt(torch.sum(d * d, -1) + 1e-30)
    return torch.sum(jabs(d) ** p, -1) ** (1.0 / p)


@register("pdist")
def pdist(x, p=2.0):
    n = x.shape[0]
    iu, ju = torch.triu_indices(n, n, 1, device=x.device)
    d = x[iu] - x[ju]
    if p == 2.0:
        return torch.sqrt(torch.sum(d * d, -1) + 1e-30)
    return torch.sum(jabs(d) ** p, -1) ** (1.0 / p)


@register("renorm", method=True)
def renorm(x, p, axis, max_norm):
    xm = torch.movedim(x, axis, 0)
    flat = xm.reshape(xm.shape[0], -1)
    norms = torch.sum(jabs(flat) ** p, -1) ** (1.0 / p)
    scale = torch.where(norms > max_norm, max_norm / (norms + 1e-12),
                        torch.ones_like(norms))
    out = flat * scale[:, None]
    return torch.movedim(out.reshape(xm.shape), 0, axis)


@register("cholesky_inverse")
def cholesky_inverse(x, upper=False):
    """inv(A) from A's Cholesky factor, by triangular solves."""
    eye = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
    return torch.cholesky_solve(eye.expand(x.shape), _factor(x, upper),
                                upper=upper)


@register("lu_unpack", nondiff_args=(1,))
def lu_unpack(lu_data, lu_pivots, unpack_ludata=True, unpack_pivots=True):
    """(P, L, U) of the reference's composition: its pivots are 1-based
    sequential swaps (one less is subtracted)."""
    m, n = lu_data.shape[-2], lu_data.shape[-1]
    k = builtins.min(m, n)
    L = torch.tril(lu_data[..., :, :k], -1) + torch.eye(
        m, k, dtype=lu_data.dtype, device=lu_data.device)
    U = torch.triu(lu_data[..., :k, :])
    piv = lu_pivots.long() - 1
    batch = piv.shape[:-1]
    perm = torch.arange(m, device=lu_data.device).expand(
        tuple(batch) + (m,)).clone()
    for i in range(piv.shape[-1]):
        j = piv[..., i:i + 1]
        pi = perm[..., i:i + 1].clone()
        pj = torch.gather(perm, -1, j)
        perm[..., i:i + 1] = pj
        perm.scatter_(-1, j, pi)
    P = torch.eye(m, dtype=lu_data.dtype,
                  device=lu_data.device)[perm].transpose(-1, -2)
    return (P if unpack_pivots else None,
            L if unpack_ludata else None,
            U if unpack_ludata else None)


@register("tensordot")
def tensordot(x, y, axes=2):
    if isinstance(axes, (list, tuple)) and len(axes) == 2 and \
            isinstance(axes[0], (list, tuple)):
        axes = (list(axes[0]), list(axes[1]))
    return torch.tensordot(x, y, dims=axes)
