"""``mx.np.linalg`` (counterpart of ``mxnet_tpu/numpy/linalg.py``) over
``torch.linalg``: cuSOLVER and cuBLAS on the card, LAPACK on the host.

Factorizations whose signs and orders are not unique (``svd``, ``eig``,
``eigh``, ``qr``) differ between cuSOLVER, LAPACK and XLA: compare them
by reconstruction and by sorted eigenvalues.  ``lstsq`` goes through the
SVD (torch's CUDA ``lstsq`` has only the full-rank ``gels`` driver), so
it gives numpy's minimum-norm solution at any rank.
"""
from __future__ import annotations

import torch

from . import _lift

__all__ = ["norm", "svd", "qr", "cholesky", "inv", "pinv", "det", "slogdet",
           "solve", "lstsq", "eig", "eigh", "eigvals", "eigvalsh",
           "matrix_rank", "matrix_power", "multi_dot", "tensorinv",
           "tensorsolve", "cond"]


def _f(a):
    return a if a.dtype.is_floating_point or a.dtype.is_complex else \
        a.to(torch.float32)


def _norm(x, ord=None, axis=None, keepdims=False):
    return torch.linalg.norm(_f(x), ord=ord, dim=axis, keepdim=keepdims)


def _svd(a, full_matrices=True, compute_uv=True, hermitian=False):
    if not compute_uv:
        return torch.linalg.svdvals(_f(a))
    return tuple(torch.linalg.svd(_f(a), full_matrices=full_matrices))


def _qr(a, mode="reduced"):
    out = torch.linalg.qr(_f(a), mode=mode)
    return out.R if mode == "r" else tuple(out)


def _pinv(a, rcond=None, hermitian=False, rtol=None):
    tol = rtol if rtol is not None else rcond
    return torch.linalg.pinv(_f(a), rtol=tol, hermitian=hermitian)


def _lstsq(a, b, rcond=None):
    a, b = _f(a), _f(b)
    m, n = a.shape[-2], a.shape[-1]
    u, s, vh = torch.linalg.svd(a, full_matrices=False)
    eps = torch.finfo(s.dtype).eps
    cut = (rcond if rcond is not None else eps * max(m, n)) * s.max()
    keep = s > cut
    sinv = torch.where(keep, 1.0 / torch.where(keep, s, torch.ones_like(s)),
                       torch.zeros_like(s))
    vec = b.dim() == 1
    bb = b[:, None] if vec else b
    x = vh.mT @ (sinv[:, None] * (u.mT @ bb))
    rank = keep.sum()
    if m > n and int(rank) == n:
        r = bb - a @ x
        res = (r * r).sum(0)
    else:
        res = torch.zeros(0, dtype=x.dtype, device=x.device)
    return (x[:, 0] if vec else x), res, rank, s


def _eigh(a, UPLO="L"):
    return tuple(torch.linalg.eigh(_f(a), UPLO=UPLO))


def _matrix_rank(M, tol=None, hermitian=False, rtol=None):
    M = _f(M)
    if tol is not None:
        return torch.linalg.matrix_rank(M, atol=tol, rtol=0.0,
                                        hermitian=hermitian)
    return torch.linalg.matrix_rank(M, rtol=rtol, hermitian=hermitian)


def _tensorsolve(a, b, axes=None):
    return torch.linalg.tensorsolve(_f(a), _f(b), dims=axes)


norm = _lift(_norm, "norm")
svd = _lift(_svd, "svd")
qr = _lift(_qr, "qr")
cholesky = _lift(lambda a: torch.linalg.cholesky(_f(a)), "cholesky")
inv = _lift(lambda a: torch.linalg.inv(_f(a)), "inv")
pinv = _lift(_pinv, "pinv")
det = _lift(lambda a: torch.linalg.det(_f(a)), "det")
slogdet = _lift(lambda a: tuple(torch.linalg.slogdet(_f(a))), "slogdet")
solve = _lift(lambda a, b: torch.linalg.solve(_f(a), _f(b)), "solve")
lstsq = _lift(_lstsq, "lstsq")
eig = _lift(lambda a: tuple(torch.linalg.eig(_f(a))), "eig")
eigh = _lift(_eigh, "eigh")
eigvals = _lift(lambda a: torch.linalg.eigvals(_f(a)), "eigvals")
eigvalsh = _lift(lambda a, UPLO="L": torch.linalg.eigvalsh(_f(a),
                                                           UPLO=UPLO),
                 "eigvalsh")
matrix_rank = _lift(_matrix_rank, "matrix_rank")
matrix_power = _lift(lambda a, n: torch.linalg.matrix_power(a, n),
                     "matrix_power")
multi_dot = _lift(lambda arrays: torch.linalg.multi_dot(
    [_f(a) for a in arrays]), "multi_dot")
tensorinv = _lift(lambda a, ind=2: torch.linalg.tensorinv(_f(a), ind=ind),
                  "tensorinv")
tensorsolve = _lift(_tensorsolve, "tensorsolve")
cond = _lift(lambda x, p=None: torch.linalg.cond(_f(x), p=p), "cond")
