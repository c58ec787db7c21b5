"""Batched BLAS / LAPACK ops ``_linalg_*`` (counterpart of
``mxnet_tpu/ops/linalg.py``, the reference's ``la_op.cc``) over
``torch.linalg``: cuBLAS and cuSOLVER on the card.  Each op broadcasts
over leading batch dims, as the reference's batched mode does, and is
differentiable through torch's own gradients of these functions.
"""
from __future__ import annotations

import torch

from .registry import register

__all__ = []


def _t(x, do):
    return x.mT if do else x


def _both(name):
    return register(name, aliases=(name[1:],))


@_both("_linalg_gemm")
def _linalg_gemm(A, B, C, *, transpose_a=False, transpose_b=False,
                 alpha=1.0, beta=1.0, axis=-3):
    return alpha * torch.matmul(_t(A, transpose_a), _t(B, transpose_b)) \
        + beta * C


@_both("_linalg_gemm2")
def _linalg_gemm2(A, B, *, transpose_a=False, transpose_b=False,
                  alpha=1.0, axis=-3):
    return alpha * torch.matmul(_t(A, transpose_a), _t(B, transpose_b))


@_both("_linalg_potrf")
def _linalg_potrf(A, *, lower=True):
    L = torch.linalg.cholesky(A)
    return L if lower else L.mT


@_both("_linalg_potri")
def _linalg_potri(A, *, lower=True):
    """``(L L^T)^-1`` from the Cholesky factor ``A`` (L, or U when
    ``lower`` is False)."""
    L = A if lower else A.mT
    eye = torch.eye(L.shape[-1], dtype=L.dtype,
                    device=L.device).expand(L.shape)
    Linv = torch.linalg.solve_triangular(L, eye, upper=False)
    return torch.matmul(Linv.mT, Linv)


@_both("_linalg_trmm")
def _linalg_trmm(A, B, *, transpose=False, rightside=False, lower=True,
                 alpha=1.0):
    tri = _t(torch.tril(A) if lower else torch.triu(A), transpose)
    out = torch.matmul(B, tri) if rightside else torch.matmul(tri, B)
    return alpha * out


@_both("_linalg_trsm")
def _linalg_trsm(A, B, *, transpose=False, rightside=False, lower=True,
                 alpha=1.0):
    eff_lower = lower != transpose
    tri = _t(torch.tril(A) if lower else torch.triu(A), transpose)
    return torch.linalg.solve_triangular(tri, alpha * B, upper=not eff_lower,
                                         left=not rightside)


@_both("_linalg_syrk")
def _linalg_syrk(A, *, transpose=False, alpha=1.0):
    return alpha * (torch.matmul(A.mT, A) if transpose
                    else torch.matmul(A, A.mT))


@_both("_linalg_syevd")
def _linalg_syevd(A):
    """``(U, L)``: the rows of U are the eigenvectors."""
    w, v = torch.linalg.eigh(A)
    return v.mT, w


@_both("_linalg_gelqf")
def _linalg_gelqf(A):
    """LQ factorization ``A = L Q``, Q with orthonormal rows."""
    q, r = torch.linalg.qr(A.mT)
    return r.mT, q.mT


@_both("_linalg_det")
def _linalg_det(A):
    return torch.linalg.det(A)


@_both("_linalg_slogdet")
def _linalg_slogdet(A):
    sign, logdet = torch.linalg.slogdet(A)
    return sign, logdet


@_both("_linalg_inverse")
def _linalg_inverse(A):
    return torch.linalg.inv(A)


@_both("_linalg_extractdiag")
def _linalg_extractdiag(A, *, offset=0):
    return torch.diagonal(A, offset=offset, dim1=-2, dim2=-1)


@_both("_linalg_makediag")
def _linalg_makediag(A, *, offset=0):
    return torch.diag_embed(A, offset=offset)


def _tri_index(n, offset, lower, device):
    ij = (torch.tril_indices(n, n, offset, device=device) if lower
          else torch.triu_indices(n, n, offset, device=device))
    return ij[0], ij[1]


@_both("_linalg_extracttrian")
def _linalg_extracttrian(A, *, offset=0, lower=True):
    rows, cols = _tri_index(A.shape[-1], offset, lower, A.device)
    return A[..., rows, cols]


@_both("_linalg_maketrian")
def _linalg_maketrian(A, *, offset=0, lower=True):
    m = A.shape[-1]
    n = int((-1 + (1 + 8 * m) ** 0.5) / 2) + abs(offset)
    rows, cols = _tri_index(n, offset, lower, A.device)
    out = torch.zeros(A.shape[:-1] + (n, n), dtype=A.dtype, device=A.device)
    flat = out.reshape(-1, n * n)
    idx = (rows * out.shape[-1] + cols).expand(flat.shape[0], -1)
    return flat.scatter(1, idx, A.reshape(flat.shape[0], -1)).reshape(
        out.shape)


@_both("_linalg_sumlogdiag")
def _linalg_sumlogdiag(A):
    return torch.log(torch.diagonal(A, dim1=-2, dim2=-1)).sum(-1)
