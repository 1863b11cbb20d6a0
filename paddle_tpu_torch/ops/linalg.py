"""Linear algebra ops: port of paddle_tpu/ops/linalg.py (reference:
python/paddle/tensor/linalg.py). ``matmul`` takes paddle's ``transpose_x``
/ ``transpose_y``; the decompositions are torch.linalg's."""
from __future__ import annotations

import math as _math

import numpy as np
import torch

from ..tensor import def_op


@def_op("matmul")
def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    if transpose_x and x.dim() > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.dim() > 1:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


@def_op("mm")
def mm(input, mat2, name=None):
    return torch.matmul(input, mat2)


@def_op("bmm")
def bmm(x, y, name=None):
    return torch.matmul(x, y)


@def_op("dot")
def dot(x, y, name=None):
    return torch.sum(x * y, -1)


@def_op("mv")
def mv(x, vec, name=None):
    return torch.matmul(x, vec)


def _norm(x, p=None, axis=None, keepdim=False):
    if p is None:
        p = "fro" if axis is None or isinstance(axis, (list, tuple)) else 2
    if isinstance(axis, (list, tuple)):
        axis = tuple(int(a) for a in axis)
    dims = tuple(range(x.dim())) if axis is None else axis
    if p == "fro":
        return torch.sqrt(torch.sum(x * x, dims, keepdim=keepdim)) \
            if axis is not None else torch.sqrt(torch.sum(x * x))
    if p == "nuc":
        s = torch.linalg.svdvals(x)
        return torch.sum(s, -1, keepdim=keepdim)
    if p in (np.inf, "inf"):
        return torch.amax(torch.abs(x), dims, keepdim=keepdim)
    if p in (-np.inf, "-inf"):
        return torch.amin(torch.abs(x), dims, keepdim=keepdim)
    if p == 0:
        return torch.sum((x != 0).to(x.dtype), dims, keepdim=keepdim)
    return torch.sum(torch.abs(x) ** p, dims, keepdim=keepdim) ** (1.0 / p)


@def_op("norm")
def norm(x, p=None, axis=None, keepdim=False, name=None):
    return _norm(x, p, axis, keepdim)


@def_op("vector_norm")
def vector_norm(x, p=2.0, axis=None, keepdim=False, name=None):
    return _norm(x, p, axis, keepdim)


@def_op("matrix_norm")
def matrix_norm(x, p="fro", axis=(-2, -1), keepdim=False, name=None):
    return torch.linalg.matrix_norm(x, ord=p, dim=tuple(axis),
                                    keepdim=keepdim)


@def_op("dist")
def dist(x, y, p=2, name=None):
    return _norm(x - y, float(p))


@def_op("cond_op")
def cond(x, p=None, name=None):
    return torch.linalg.cond(x, p)


@def_op("cholesky")
def cholesky(x, upper=False, name=None):
    return torch.linalg.cholesky(x, upper=upper)


@def_op("cholesky_solve")
def cholesky_solve(x, y, upper=False, name=None):
    return torch.cholesky_solve(x, y, upper=upper)


@def_op("inverse")
def inverse(x, name=None):
    return torch.linalg.inv(x)


@def_op("pinv")
def pinv(x, rcond=1e-15, hermitian=False, name=None):
    return torch.linalg.pinv(x, rtol=rcond, hermitian=hermitian)


@def_op("det")
def det(x, name=None):
    return torch.linalg.det(x)


@def_op("slogdet")
def slogdet(x, name=None):
    sign, logabs = torch.linalg.slogdet(x)
    return torch.stack([sign, logabs])


@def_op("matrix_power")
def matrix_power(x, n, name=None):
    return torch.linalg.matrix_power(x, int(n))


@def_op("matrix_rank")
def matrix_rank(x, tol=None, hermitian=False, name=None):
    return torch.linalg.matrix_rank(x, rtol=tol, hermitian=hermitian)


def qr(x, mode="reduced", name=None):
    r = def_op("qr")(lambda v: tuple(torch.linalg.qr(v, mode=mode)))(x)
    return (r[1],) if mode == "r" else r


def svd(x, full_matrices=False, name=None):
    def _svd(v):
        u, s, vh = torch.linalg.svd(v, full_matrices=full_matrices)
        return u, s, vh.transpose(-1, -2).conj()
    return def_op("svd")(_svd)(x)


def eig(x, name=None):
    return def_op("eig")(lambda v: tuple(torch.linalg.eig(v)))(x)


def eigh(x, UPLO="L", name=None):
    return def_op("eigh")(lambda v: tuple(torch.linalg.eigh(v, UPLO)))(x)


@def_op("eigvals")
def eigvals(x, name=None):
    return torch.linalg.eigvals(x)


@def_op("eigvalsh")
def eigvalsh(x, UPLO="L", name=None):
    return torch.linalg.eigvalsh(x, UPLO)


def lu(x, pivot=True, get_infos=False, name=None):
    def _lu(v):
        lu_mat, piv = torch.linalg.lu_factor(v)
        return lu_mat, piv.to(torch.int32)   # 1-based, as paddle's
    lu_mat, piv = def_op("lu")(_lu)(x)
    if get_infos:
        from .creation import zeros
        return lu_mat, piv, zeros([1], "int32")
    return lu_mat, piv


@def_op("solve")
def solve(x, y, name=None):
    return torch.linalg.solve(x, y)


@def_op("triangular_solve")
def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False,
                     name=None):
    a = x.transpose(-1, -2) if transpose else x
    return torch.linalg.solve_triangular(
        a, y, upper=(not upper) if transpose else upper,
        unitriangular=unitriangular)


def lstsq(x, y, rcond=None, driver=None, name=None):
    def _l(a, b):
        r = torch.linalg.lstsq(a, b, rcond=rcond)
        return r.solution, r.residuals, r.rank, r.singular_values
    return def_op("lstsq")(_l)(x, y)


@def_op("multi_dot")
def multi_dot(x, name=None):
    return torch.linalg.multi_dot(list(x))


@def_op("cross")
def cross(x, y, axis=9, name=None):
    if axis == 9:
        axis = next((i for i, s in enumerate(x.shape) if s == 3), -1)
    return torch.linalg.cross(x, y, dim=int(axis))


@def_op("histogram")
def histogram(x, bins=100, min=0, max=0, name=None):
    lo, hi = (min, max) if (min != 0 or max != 0) else (
        float(x.min()), float(x.max()))
    return torch.histc(x.float(), bins=int(bins), min=lo, max=hi).to(
        torch.int32)


@def_op("householder_product")
def householder_product(x, tau, name=None):
    return torch.linalg.householder_product(x, tau)


@def_op("corrcoef")
def corrcoef(x, rowvar=True, name=None):
    return torch.corrcoef(x if rowvar else x.t())


@def_op("cov")
def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    return torch.cov(x if rowvar else x.t(), correction=1 if ddof else 0,
                     fweights=fweights, aweights=aweights)


def matrix_exp(x, name=None):
    return def_op("matrix_exp")(torch.linalg.matrix_exp)(x)


@def_op("cdist")
def cdist(x, y, p=2.0, compute_mode="use_mm_for_euclid_dist_if_necessary",
          name=None):
    """Pairwise p-norm distance [.., P, M] x [.., R, M] -> [.., P, R]."""
    if p == 2.0 and compute_mode != "donot_use_mm_for_euclid_dist":
        x2 = torch.sum(x * x, -1, keepdim=True)
        y2 = torch.sum(y * y, -1, keepdim=True)
        sq = x2 + y2.transpose(-2, -1) - 2 * torch.matmul(
            x, y.transpose(-2, -1))
        return torch.sqrt(torch.clamp_min(sq, 0.0))
    diff = torch.abs(x[..., :, None, :] - y[..., None, :, :])
    if p == 0:
        return torch.sum((diff != 0).to(x.dtype), -1)
    if _math.isinf(p):
        return torch.amax(diff, -1)
    return torch.sum(diff ** p, -1) ** (1.0 / p)


@def_op("pdist")
def pdist(x, p=2.0, name=None):
    """Condensed pairwise distances of an [N, M] matrix."""
    iu = torch.triu_indices(x.shape[0], x.shape[0], 1, device=x.device)
    diff = torch.abs(x[iu[0]] - x[iu[1]])
    if p == 0:
        return torch.sum((diff != 0).to(x.dtype), -1)
    if _math.isinf(p):
        return torch.amax(diff, -1)
    return torch.sum(diff ** p, -1) ** (1.0 / p)


def lu_unpack(x, y, unpack_ludata=True, unpack_pivots=True, name=None):
    """(P, L, U) of lu()'s packed LU and 1-based pivots, A = P @ L @ U."""
    P, L, U = def_op("lu_unpack")(
        lambda a, p: tuple(torch.lu_unpack(a, p)))(x, y)
    return (P if unpack_pivots else None,
            L if unpack_ludata else None, U if unpack_ludata else None)


@def_op("lu_solve")
def lu_solve(b, lu_data, lu_pivots, trans=0, name=None):
    return torch.linalg.lu_solve(lu_data, lu_pivots.to(torch.int32), b,
                                 adjoint=bool(trans))


@def_op("cholesky_inverse")
def cholesky_inverse(x, upper=False, name=None):
    return torch.cholesky_inverse(x, upper=upper)


@def_op("ormqr")
def ormqr(x, tau, other, left=True, transpose=False, name=None):
    """Multiply ``other`` by Q of a geqrf factorization."""
    return torch.ormqr(x, tau, other, left=left, transpose=transpose)


@def_op("vecdot")
def vecdot(x, y, axis=-1, name=None):
    return torch.sum(x * y, axis)


@def_op("baddbmm")
def baddbmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    return beta * input + alpha * torch.matmul(x, y)


@def_op("logdet")
def logdet(x, name=None):
    return torch.linalg.slogdet(x)[1]


def svd_lowrank(x, q=6, niter=2, M=None, name=None):
    """Randomized low-rank SVD (Halko et al. subspace iteration), the
    Gaussian test matrix drawn from ``next_key()`` as the reference."""
    from ..framework import prng
    from ..framework.random import next_key

    def _svd_lowrank(v, m=None):
        mm_, n = v.shape[-2], v.shape[-1]
        A = v if m is None else v - m
        k = min(q, mm_, n)
        G = prng.normal(next_key(), v.shape[:-2] + (n, k), v.dtype,
                        device=v.device)
        Q, _ = torch.linalg.qr(A @ G)
        for _ in range(niter):
            Q, _ = torch.linalg.qr(A.transpose(-2, -1) @ Q)
            Q, _ = torch.linalg.qr(A @ Q)
        B = Q.transpose(-2, -1) @ A
        u, s, vh = torch.linalg.svd(B, full_matrices=False)
        return Q @ u, s, vh.transpose(-2, -1)
    return def_op("svd_lowrank")(_svd_lowrank)(x, M)


def pca_lowrank(x, q=None, center=True, niter=2, name=None):
    """Randomized PCA via svd_lowrank on the centered matrix."""
    if q is None:
        q = min(6, x.shape[-2], x.shape[-1])
    if center:
        x = def_op("pca_center")(
            lambda v: v - v.mean(-2, keepdim=True))(x)
    return svd_lowrank(x, q=q, niter=niter)
