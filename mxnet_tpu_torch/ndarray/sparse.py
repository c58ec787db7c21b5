"""Sparse storage: ``row_sparse`` and ``csr`` (counterpart of
``mxnet_tpu/ndarray/sparse.py``), as ``mx.nd.sparse``.

A :class:`RowSparseNDArray` is ``(data, indices)``: the rows ``indices``
(sorted, int32, as the reference stores them) of a ``shape``-d array
hold ``data``; every other row is zero.  A :class:`CSRNDArray` is the
2-D ``(data, indices, indptr)`` layout.  Both hold torch tensors on one
device: the device of the tensors or arrays they are built from, else
the current context's, as ``mx.nd.array`` does.

Row-sparse is the gradient format of embedding-style updates: an
``Embedding(sparse_grad=True)`` backward yields one, and the optimizers'
lazy updates (:func:`lazy_apply`) touch only its rows.  The reference's
sums over rows are XLA's ``segment_sum``; here every sum of rows runs in
a fixed order, so two runs give the same bits on a card as on the host:
the ids are sorted stably and each run of equal ids is summed by
``torch.segment_reduce`` (one thread an output, in order), never by
``index_add_``, whose CUDA form adds with float atomics.

The storage-fallback log (``MXNET_STORAGE_FALLBACK_LOG_VERBOSE``) warns
where a sparse array is made dense to run an op without a sparse form.
"""
from __future__ import annotations

import os
import warnings
from typing import Tuple

import numpy as onp
import torch

from ..base import MXNetError, np_dtype, torch_dtype
from ..context import current_context
from .ndarray import NDArray, array as _dense_array

__all__ = ["BaseSparseNDArray", "RowSparseNDArray", "CSRNDArray",
           "row_sparse_array", "csr_matrix", "zeros", "array",
           "cast_storage", "retain", "dot", "add", "where_rows",
           "coalesce_rows", "merge", "reduce_list", "segment_sum",
           "lazy_apply", "sgd_update", "sgd_mom_update", "adagrad_update"]


def _log_storage_fallback(what: str):
    """Warn, under ``MXNET_STORAGE_FALLBACK_LOG_VERBOSE``, that a sparse
    array was made dense."""
    if os.environ.get("MXNET_STORAGE_FALLBACK_LOG_VERBOSE", "0") not in \
            ("0", ""):
        warnings.warn(
            f"storage fallback: {what} densified (generated dense output "
            f"instead of sparse)", stacklevel=3)


def _tensor(x, device=None, dtype=None) -> torch.Tensor:
    """``x`` (a tensor, NDArray, numpy array or list) as a tensor: a
    tensor or NDArray keeps its device unless ``device`` is given, host
    data goes to ``device`` or the current context's."""
    if isinstance(x, NDArray):
        x = x._data
    if isinstance(x, torch.Tensor):
        t = x.detach()
    else:
        a = onp.asarray(x)
        if a.dtype == onp.float64 and dtype is None:
            a = a.astype(onp.float32)
        t = torch.from_numpy(onp.array(a, order="C", copy=True))
        if device is None:
            device = current_context().torch_device
    if dtype is not None:
        t = t.to(torch_dtype(dtype))
    if device is not None:
        t = t.to(device)
    return t


def _dtype_of(t: torch.Tensor):
    """The dtype an NDArray over ``t`` reports (numpy's, bfloat16 as
    torch's)."""
    if t.dtype == torch.bfloat16:
        return torch.bfloat16
    return np_dtype(t.dtype)


def segment_sum(values: torch.Tensor, ids: torch.Tensor):
    """``(unique sorted ids, summed rows)`` of ``values`` (one row an
    id): the ids are sorted stably and each run of equal ids is summed
    in its original order, so the result is the same bits on every run
    and on every device (and equals numpy's ``add.at`` in that order)."""
    ids = ids.reshape(-1).long()
    if ids.numel() == 0:
        return ids, values.reshape((0,) + tuple(values.shape[1:]))
    sorted_ids, order = torch.sort(ids, stable=True)
    uniq, counts = torch.unique_consecutive(sorted_ids, return_counts=True)
    vals = values.index_select(0, order)
    if uniq.numel() == ids.numel():
        return uniq, vals
    return uniq, torch.segment_reduce(vals, "sum", lengths=counts, axis=0,
                                      unsafe=True)


class BaseSparseNDArray:
    """What both sparse storage types share."""

    stype = "undefined"

    def __init__(self, shape, dtype):
        self._shape = tuple(int(s) for s in shape)
        self._dtype = dtype

    @property
    def shape(self):
        return self._shape

    @property
    def dtype(self):
        return self._dtype

    @property
    def ndim(self):
        return len(self._shape)

    @property
    def context(self):
        from ..context import Context
        return Context.of(self.data.device)

    ctx = context

    def asnumpy(self) -> onp.ndarray:
        return self.todense().asnumpy()

    def wait_to_read(self):
        if self.data.is_cuda:
            torch.cuda.current_stream(self.data.device).synchronize()

    def __repr__(self):
        return (f"\n<{type(self).__name__} "
                f"{'x'.join(map(str, self.shape))} nnz={self.nnz}>")

    def tostype(self, stype: str):
        if stype == self.stype:
            return self
        if stype == "default":
            return self.todense()
        return cast_storage(self.todense(), stype)

    def copyto(self, other):
        if isinstance(other, NDArray):
            other._rebind(self.todense()._data.to(other._data.device))
            return other
        if isinstance(other, type(self)):
            for attr in ("data", "indices", "indptr"):
                if hasattr(self, attr):
                    setattr(other, attr, getattr(self, attr))
            other._shape = tuple(self.shape)
            other._dtype = self.dtype
            return other
        raise MXNetError("copyto: unsupported target for sparse")

    def copy(self):
        import copy as _copy
        return _copy.copy(self)


class RowSparseNDArray(BaseSparseNDArray):
    """Rows ``indices`` hold ``data``; every other row is zero."""

    stype = "row_sparse"

    def __init__(self, data, indices, shape):
        data = _tensor(data)
        indices = _tensor(indices, device=data.device, dtype="int32")
        super().__init__(shape, _dtype_of(data))
        if tuple(data.shape[1:]) != tuple(shape[1:]):
            raise MXNetError(
                f"row_sparse data row shape {tuple(data.shape[1:])} != "
                f"array row shape {tuple(shape[1:])}")
        if data.shape[0] != indices.shape[0]:
            raise MXNetError("row_sparse data/indices length mismatch")
        self.data = data          # (nnz rows, *row shape)
        self.indices = indices    # (nnz rows,) sorted

    @property
    def nnz(self):
        return int(self.data.shape[0])

    def todense(self) -> NDArray:
        _log_storage_fallback("row_sparse")
        out = torch.zeros(self.shape, dtype=self.data.dtype,
                          device=self.data.device)
        if self.nnz:
            out.index_copy_(0, self.indices.long(), self.data)
        return NDArray._wrap(out)

    def retain(self, indices) -> "RowSparseNDArray":
        return retain(self, indices)

    def as_in_context(self, ctx):
        dev = ctx.torch_device
        return RowSparseNDArray(self.data.to(dev), self.indices.to(dev),
                                self.shape)

    def __neg__(self):
        return RowSparseNDArray(-self.data, self.indices, self.shape)

    def __mul__(self, scalar):
        return RowSparseNDArray(self.data * scalar, self.indices, self.shape)

    __rmul__ = __mul__

    def __truediv__(self, scalar):
        return RowSparseNDArray(self.data / scalar, self.indices, self.shape)

    def __add__(self, other):
        return add(self, other)


class CSRNDArray(BaseSparseNDArray):
    """A compressed-sparse-row 2-D matrix."""

    stype = "csr"

    def __init__(self, data, indices, indptr, shape):
        data = _tensor(data)
        super().__init__(shape, _dtype_of(data))
        if len(shape) != 2:
            raise MXNetError("csr storage is 2-D only")
        self.data = data                                          # (nnz,)
        self.indices = _tensor(indices, data.device, "int32")     # columns
        self.indptr = _tensor(indptr, data.device, "int32")       # rows+1

    @property
    def nnz(self):
        return int(self.data.shape[0])

    def _row_ids(self) -> torch.Tensor:
        counts = (self.indptr[1:] - self.indptr[:-1]).long()
        return torch.repeat_interleave(
            torch.arange(self.shape[0], device=self.data.device), counts)

    def todense(self) -> NDArray:
        _log_storage_fallback("csr")
        out = torch.zeros(self.shape, dtype=self.data.dtype,
                          device=self.data.device)
        if self.nnz:
            out[self._row_ids(), self.indices.long()] = self.data
        return NDArray._wrap(out)

    def __getitem__(self, i):
        if isinstance(i, slice):
            if i == slice(None):
                return self
            raise MXNetError("csr slicing supports full slice only")
        if i < 0:
            i += self.shape[0]
        if not 0 <= i < self.shape[0]:
            raise IndexError(f"row {i} out of bounds for {self.shape}")
        lo, hi = int(self.indptr[i]), int(self.indptr[i + 1])
        out = torch.zeros((1, self.shape[1]), dtype=self.data.dtype,
                          device=self.data.device)
        out[0, self.indices[lo:hi].long()] = self.data[lo:hi]
        return NDArray._wrap(out)


# --------------------------------------------------------------------------
# constructors (``mx.nd.sparse.row_sparse_array`` / ``csr_matrix``)
# --------------------------------------------------------------------------

def _dense_source(arg, dtype):
    if isinstance(arg, NDArray):
        t = arg._data.detach()
    elif isinstance(arg, torch.Tensor):
        t = arg.detach()
    else:
        t = _tensor(arg)
    return NDArray._wrap(t if dtype is None else t.to(torch_dtype(dtype)))


def row_sparse_array(arg, shape=None, dtype=None) -> RowSparseNDArray:
    if isinstance(arg, RowSparseNDArray):
        return arg
    if isinstance(arg, tuple) and len(arg) == 2:
        data, indices = arg
        if shape is None:
            raise MXNetError("row_sparse_array((data, indices)) needs shape")
        return RowSparseNDArray(_tensor(data, dtype=dtype), indices, shape)
    return cast_storage(_dense_source(arg, dtype), "row_sparse")


def csr_matrix(arg, shape=None, dtype=None) -> CSRNDArray:
    if isinstance(arg, CSRNDArray):
        return arg
    if isinstance(arg, tuple) and len(arg) == 3:
        data, indices, indptr = arg
        if shape is None:
            raise MXNetError("csr_matrix((data, indices, indptr)) needs shape")
        return CSRNDArray(_tensor(data, dtype=dtype), indices, indptr, shape)
    return cast_storage(_dense_source(arg, dtype), "csr")


def zeros(stype: str, shape, ctx=None, dtype=None):
    dt = torch_dtype(dtype)
    dev = (ctx or current_context()).torch_device
    shape = tuple(shape)
    if stype == "row_sparse":
        return RowSparseNDArray(
            torch.zeros((0,) + shape[1:], dtype=dt, device=dev),
            torch.zeros((0,), dtype=torch.int32, device=dev), shape)
    if stype == "csr":
        return CSRNDArray(torch.zeros((0,), dtype=dt, device=dev),
                          torch.zeros((0,), dtype=torch.int32, device=dev),
                          torch.zeros((shape[0] + 1,), dtype=torch.int32,
                                      device=dev), shape)
    if stype == "default":
        from .ndarray import zeros as dzeros
        return dzeros(shape, ctx=ctx, dtype=dtype)
    raise MXNetError(f"unknown storage type {stype!r}")


def array(source, stype="default", shape=None, dtype=None):
    if stype == "row_sparse":
        return row_sparse_array(source, shape=shape, dtype=dtype)
    if stype == "csr":
        return csr_matrix(source, shape=shape, dtype=dtype)
    return _dense_array(source, dtype=dtype)


# --------------------------------------------------------------------------
# cast_storage
# --------------------------------------------------------------------------

def cast_storage(arr, stype: str):
    if isinstance(arr, BaseSparseNDArray):
        return arr.tostype(stype)
    if stype == "default":
        return arr
    a = arr._data.detach() if isinstance(arr, NDArray) else _tensor(arr)
    if stype == "row_sparse":
        live = a.reshape(a.shape[0], -1).ne(0).any(dim=1) if a.dim() > 1 \
            else a.ne(0)
        nz = torch.nonzero(live).reshape(-1)
        return RowSparseNDArray(a.index_select(0, nz), nz, tuple(a.shape))
    if stype == "csr":
        if a.dim() != 2:
            raise MXNetError("csr storage is 2-D only")
        rows, cols = torch.nonzero(a, as_tuple=True)
        indptr = torch.zeros(a.shape[0] + 1, dtype=torch.int64,
                             device=a.device)
        indptr[1:] = torch.cumsum(torch.bincount(rows,
                                                 minlength=a.shape[0]), 0)
        return CSRNDArray(a[rows, cols], cols, indptr, tuple(a.shape))
    raise MXNetError(f"unknown storage type {stype!r}")


# --------------------------------------------------------------------------
# sparse ops: retain, dot, add
# --------------------------------------------------------------------------

def retain(rsp: RowSparseNDArray, indices) -> RowSparseNDArray:
    """Keep only the requested rows."""
    want = _tensor(indices, device=rsp.indices.device).reshape(-1).long()
    keep = torch.isin(rsp.indices.long(), want)
    return RowSparseNDArray(rsp.data[keep], rsp.indices[keep], rsp.shape)


def _csr_dot(lhs: CSRNDArray, rhs: torch.Tensor, transpose_a: bool):
    rows_out = lhs.shape[1] if transpose_a else lhs.shape[0]
    out = torch.zeros((rows_out,) + tuple(rhs.shape[1:]),
                      dtype=torch.promote_types(lhs.data.dtype, rhs.dtype),
                      device=rhs.device)
    if not lhs.nnz:
        return out
    row_ids, cols = lhs._row_ids(), lhs.indices.long()
    src, dst = (row_ids, cols) if transpose_a else (cols, row_ids)
    prods = lhs.data.reshape((-1,) + (1,) * (rhs.dim() - 1)).to(out.dtype) \
        * rhs.index_select(0, src).to(out.dtype)
    uniq, summed = segment_sum(prods, dst)
    out.index_copy_(0, uniq, summed)
    return out


def dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """Sparse-aware dot: csr·dense, csrᵀ·dense, row_sparse(ᵀ)·dense."""
    if isinstance(lhs, CSRNDArray) and isinstance(rhs, NDArray):
        return NDArray._wrap(_csr_dot(lhs, rhs._data, transpose_a))
    if isinstance(lhs, RowSparseNDArray) and isinstance(rhs, NDArray):
        if not transpose_a:
            return NDArray._wrap(torch.matmul(lhs.todense()._data,
                                              rhs._data))
        dt = torch.promote_types(lhs.data.dtype, rhs._data.dtype)
        if not lhs.nnz:
            return NDArray._wrap(torch.zeros(
                (lhs.shape[1], rhs.shape[1]), dtype=dt,
                device=rhs._data.device))
        picked = rhs._data.index_select(0, lhs.indices.long())
        return NDArray._wrap(torch.einsum("nr,nc->rc", lhs.data.to(dt),
                                          picked.to(dt)))
    if isinstance(lhs, NDArray) and isinstance(rhs, NDArray):
        from ..ops.registry import invoke
        if transpose_a:
            raise MXNetError("dot: transpose_a of a dense lhs is not "
                             "ported yet")
        return invoke("dot", [lhs, rhs], transpose_b=transpose_b)
    raise MXNetError(
        f"dot: unsupported storage combination "
        f"({getattr(lhs, 'stype', 'default')}, "
        f"{getattr(rhs, 'stype', 'default')})")


def add(lhs, rhs):
    """Elementwise add across storage types: two row_sparse arrays merge
    sparsely; anything else adds dense."""
    if isinstance(lhs, RowSparseNDArray) and isinstance(rhs,
                                                        RowSparseNDArray):
        return merge(lhs, rhs)
    a = lhs.todense() if isinstance(lhs, BaseSparseNDArray) else lhs
    b = rhs.todense() if isinstance(rhs, BaseSparseNDArray) else rhs
    return a + b


def where_rows(rsp: RowSparseNDArray) -> NDArray:
    """Indices of the non-zero rows."""
    return NDArray._wrap(rsp.indices)


# --------------------------------------------------------------------------
# row-sparse plumbing: coalescing, merging, the lazy optimizer updates
# --------------------------------------------------------------------------

def coalesce_rows(indices, values):
    """Host-side duplicate-row coalescing (numpy only: it runs on the
    parameter server's handler threads and the client's push path): the
    ids sorted, each once, its values summed.  Returns
    ``(unique_sorted_indices, summed_values)``."""
    idx = onp.asarray(indices)
    val = onp.asarray(values)
    if idx.ndim != 1 or val.shape[:1] != idx.shape:
        raise MXNetError(
            f"coalesce_rows: indices {idx.shape} / values {val.shape} "
            "mismatch (want indices (nnz,), values (nnz, ...))")
    if idx.size == 0:
        return idx, val
    uniq, inv = onp.unique(idx, return_inverse=True)
    if uniq.size == idx.size:
        order = onp.argsort(idx, kind="stable")
        return idx[order], val[order]
    out = onp.zeros((uniq.size,) + val.shape[1:], dtype=val.dtype)
    onp.add.at(out, inv, val)
    return uniq, out


def merge(a: RowSparseNDArray, b: RowSparseNDArray) -> RowSparseNDArray:
    """The sum of two row_sparse arrays at O(nnz log nnz) cost, never
    building the dense shape."""
    if tuple(a.shape) != tuple(b.shape):
        raise MXNetError(
            f"row_sparse merge: shape mismatch {a.shape} vs {b.shape}")
    rows = torch.cat([a.indices.long(), b.indices.long().to(a.data.device)])
    vals = torch.cat([a.data, b.data.to(a.data.device)])
    uniq, summed = segment_sum(vals, rows)
    return RowSparseNDArray(summed, uniq, a.shape)


def reduce_list(values) -> RowSparseNDArray:
    """The sum of a list of row_sparse arrays (a multi-value push)."""
    acc = values[0]
    for v in values[1:]:
        acc = merge(acc, v)
    return acc


def _lazy_kernel(kind: str, statics: tuple):
    """The lazy update ``kind`` on tensors: ``fn(lr, wd, w, vals, rows,
    *states)`` returns the new rows ``rows`` of the weight and of each
    state (O(nnz·dim) work; no dense gradient).  The reference's kernel,
    op for op."""
    st = dict(statics)
    rescale = st.get("rescale_grad", 1.0)
    clip = st.get("clip_gradient", -1.0)

    def prep(g, w_rows, wd):
        g = g * rescale
        if clip > 0:
            g = torch.clamp(g, -clip, clip)
        return g + wd * w_rows

    if kind == "sgd_update":
        def raw(lr, wd, w, vals, rows):
            w_rows = w.index_select(0, rows)
            g = prep(vals, w_rows, wd)
            return (w_rows - lr * g,)
    elif kind == "sgd_mom_update":
        mom_c = st.get("momentum", 0.0)

        def raw(lr, wd, w, vals, rows, mom):
            w_rows = w.index_select(0, rows)
            g = prep(vals, w_rows, wd)
            m_rows = mom_c * mom.index_select(0, rows) - lr * g
            return (w_rows + m_rows, m_rows)
    elif kind == "adagrad_update":
        eps = st.get("epsilon", 1e-7)

        def raw(lr, wd, w, vals, rows, hist):
            w_rows = w.index_select(0, rows)
            g = prep(vals, w_rows, wd)
            h_rows = hist.index_select(0, rows) + g * g
            step = lr * g / (torch.sqrt(h_rows) + eps)
            return (w_rows + -step, h_rows)
    elif kind == "adam_update":
        b1 = st.get("beta1", 0.9)
        b2 = st.get("beta2", 0.999)
        eps = st.get("epsilon", 1e-8)

        # the caller folds the bias correction into lr, as the dense
        # eager update does
        def raw(lr, wd, w, vals, rows, mean, var):
            w_rows = w.index_select(0, rows)
            g = prep(vals, w_rows, wd)
            m_rows = b1 * mean.index_select(0, rows) + (1 - b1) * g
            v_rows = b2 * var.index_select(0, rows) + (1 - b2) * g * g
            step = lr * m_rows / (torch.sqrt(v_rows) + eps)
            return (w_rows + -step, m_rows, v_rows)
    else:
        raise MXNetError(f"no row_sparse kernel for {kind!r}")
    return raw


_LAZY_SUPPORTED = {"sgd_update", "sgd_mom_update", "adagrad_update",
                   "adam_update"}


def _f32(x: float) -> float:
    """A host scalar as the reference passes it: rounded to f32."""
    return float(onp.float32(x))


@torch.no_grad()
def lazy_apply(kind: str, lr: float, wd: float, weight: NDArray,
               grad: RowSparseNDArray, states, statics: dict) -> bool:
    """One lazy update touching only ``grad.indices`` rows; the new rows
    are written into the weight's and states' tensors in place.  False
    when ``kind`` has no lazy form (the caller densifies)."""
    if kind not in _LAZY_SUPPORTED:
        return False
    fn = _lazy_kernel(kind, tuple(sorted(statics.items())))
    w = weight._data
    rows = grad.indices.long().to(w.device)
    vals = grad.data.to(w.device)
    outs = fn(_f32(lr), _f32(wd), w, vals, rows, *[s._data for s in states])
    for dst, new in zip([weight, *states], outs):
        dst._data.index_copy_(0, rows, new.to(dst._data.dtype))
    return True


def sgd_update(weight: NDArray, grad: RowSparseNDArray, lr: float,
               wd: float = 0.0, rescale_grad: float = 1.0,
               clip_gradient: float = -1.0) -> NDArray:
    """SGD on the rows present in the row_sparse gradient only."""
    lazy_apply("sgd_update", lr, wd, weight, grad, [],
               {"rescale_grad": rescale_grad, "clip_gradient": clip_gradient})
    return weight


def sgd_mom_update(weight: NDArray, grad: RowSparseNDArray, mom: NDArray,
                   lr: float, momentum: float = 0.9, wd: float = 0.0,
                   rescale_grad: float = 1.0) -> NDArray:
    """Lazy momentum: the momentum decays on the live rows only."""
    lazy_apply("sgd_mom_update", lr, wd, weight, grad, [mom],
               {"momentum": momentum, "rescale_grad": rescale_grad})
    return weight


def adagrad_update(weight: NDArray, grad: RowSparseNDArray, history: NDArray,
                   lr: float, epsilon: float = 1e-7, wd: float = 0.0,
                   rescale_grad: float = 1.0) -> NDArray:
    """Row-sparse AdaGrad."""
    lazy_apply("adagrad_update", lr, wd, weight, grad, [history],
               {"epsilon": epsilon, "rescale_grad": rescale_grad})
    return weight


def _as_rsp_of(t: torch.Tensor, shape) -> RowSparseNDArray:
    """A torch sparse COO gradient (one sparse dim) as a row_sparse
    array, its rows coalesced by :func:`segment_sum`."""
    idx = t._indices()[0]
    vals = t._values()
    if not t.is_coalesced():
        idx, vals = segment_sum(vals, idx)
    return RowSparseNDArray(vals, idx, tuple(shape))


def rsp_from_coo(t: torch.Tensor) -> RowSparseNDArray:
    """A row_sparse array from a torch sparse COO tensor whose one sparse
    dimension is its first (the gradient ``Embedding(sparse_grad=True)``
    hands to ``torch.autograd``)."""
    return _as_rsp_of(t, t.shape)


def coo_of(rsp: RowSparseNDArray) -> torch.Tensor:
    """A coalesced torch sparse COO tensor of a row_sparse array."""
    return torch.sparse_coo_tensor(rsp.indices.long()[None], rsp.data,
                                   rsp.shape, is_coalesced=True,
                                   check_invariants=False)


def to_tuple(rsp: RowSparseNDArray) -> Tuple[onp.ndarray, onp.ndarray]:
    """``(indices, values)`` on the host (the wire's form)."""
    return (rsp.indices.cpu().numpy(),
            rsp.data.detach().cpu().numpy())
