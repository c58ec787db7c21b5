"""The fused sequence-level RNN op (counterpart of
``mxnet_tpu/ops/rnn.py``): one op, ``RNN`` (alias ``rnn``), over the
four modes (``rnn_relu``, ``rnn_tanh``, ``lstm``, ``gru``), several
layers, both directions, ``use_sequence_length``, LSTMP
(``projection_size``), the returned cell state's clip and inter-layer
dropout ``p``, reading its weights from the reference's flat vector.

Flat layout (``_slice_params``, the reference's ``GetRnnParamSize``
order): for each layer, for each direction, ``W (G·H, in)`` then
``R (G·H, P)`` (then ``Wp (P, H)`` under LSTMP); after every weight, for
each (layer, direction) in the same order, ``bW (G·H,)`` then
``bR (G·H,)``.  Gates: LSTM (i, f, g, o), GRU (r, z, n) with
``n = tanh(W_n x + b_Wn + r ⊙ (R_n h + b_Rn))``; both are torch's.

Two forms compute the same function:

- :func:`rnn` (the registered op, and the Gluon layers through
  :func:`run_cells`): one ``torch._VF.{lstm,gru,rnn_tanh,rnn_relu}``
  call over views into the flat vector, in torch's per-layer list order
  ``[W, R, bW, bR(, Wp)]``: cuDNN's RNN on the card, torch's own RNN on
  the CPU.  The views are not cuDNN's packed layout, so on the card
  torch compacts them into one buffer at each call and warns that the
  weights are "not part of single contiguous chunk of memory".  With
  ``p > 0`` it calls torch once per layer (cuDNN's dropout 0) and draws
  each mask from ``mx.random`` between layers, so masks follow the
  port's generator (and a captured step's registered generator state).
  With ``use_sequence_length`` it runs torch's packed form: the rows are
  sorted by length and ``batch_sizes`` built on the host, so the call
  reads the lengths back (one sync) and cannot run inside a CUDA-graph
  capture, where it raises.
- :func:`rnn_plain`: the reference's cell step looped over T in torch
  (masked steps for ragged lengths, each row's valid prefix reversed for
  the backward direction).  It is the oracle the tests and
  ``chip_smoke.py`` hold :func:`rnn` against, never a fallback: on a
  CUDA tensor :func:`rnn` takes torch's cuDNN call or raises.

As in the reference, the cell clip (``lstm_state_clip_min`` / ``_max``)
applies to each layer's *returned* cell state only, not inside the
recurrence (cuDNN's own clip would), and only when ``_min`` is given;
dropout ``p > 0`` applies between layers whether or not the step is in
training mode (the Gluon layers pass ``p`` only in training).
"""
from __future__ import annotations

from typing import List

import torch

from ..base import MXNetError
from .registry import register

__all__ = ["rnn", "rnn_plain", "rnn_param_size", "run_cells", "cells_plain",
           "flat_cells"]

_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}


def _vf(mode):
    from torch import _VF
    return {"lstm": _VF.lstm, "gru": _VF.gru, "rnn_tanh": _VF.rnn_tanh,
            "rnn_relu": _VF.rnn_relu}[mode]


def _slice_params(params, mode, input_size, state_size, num_layers, ndir,
                  proj_size=None):
    """Views into the flat vector: ``cells[layer][dir] = (W, R, bW, bR,
    Wp or None)``."""
    G = _GATES[mode]
    H = state_size
    P = proj_size if proj_size is not None else H
    cells, off = [], 0

    def take(n, shape):
        nonlocal off
        v = params[off:off + n].view(shape)
        off += n
        return v

    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else P * ndir
        per_dir = []
        for _ in range(ndir):
            W = take(G * H * in_sz, (G * H, in_sz))
            R = take(G * H * P, (G * H, P))
            Wp = take(P * H, (P, H)) if proj_size is not None else None
            per_dir.append([W, R, Wp])
        cells.append(per_dir)
    for layer in range(num_layers):
        for d in range(ndir):
            W, R, Wp = cells[layer][d]
            bW = take(G * H, (G * H,))
            bR = take(G * H, (G * H,))
            cells[layer][d] = (W, R, bW, bR, Wp)
    if off != params.numel():
        raise MXNetError(f"RNN: the flat parameter vector holds "
                         f"{params.numel()} values, the configuration "
                         f"needs {off}")
    return cells


def rnn_param_size(mode, input_size, state_size, num_layers,
                   bidirectional=False, projection_size=None):
    """Total flat parameter count (the reference's ``GetRnnParamSize``,
    with LSTMP's projection)."""
    G = _GATES[mode]
    H = state_size
    P = projection_size if projection_size is not None else H
    D = 2 if bidirectional else 1
    size = 0
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else P * D
        size += D * (G * H * in_sz + G * H * P + 2 * G * H)
        if projection_size is not None:
            size += D * P * H
    return size


def _dropout(x, p):
    from .nn import dropout
    return dropout(x, p=p, mode="always")


def _clip_cells(c, clip_min, clip_max):
    if clip_min is None:
        return c
    return c.clamp(min=clip_min, max=clip_max)


# -- the fused form: torch's RNN call -----------------------------------------

class _Packing:
    """Torch's packed form of a ragged batch: rows sorted by length
    (longest first), the time-major order of their valid steps, and
    ``batch_sizes`` on the host.  Rows of length 0 take no part: their
    outputs stay 0 and their states the initial ones."""

    def __init__(self, lengths, T, N, device):
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise MXNetError(
                "RNN: use_sequence_length reads the lengths on the host "
                "(torch's packed sequences), which a CUDA-graph capture "
                "cannot hold; run this step uncaptured")
        lens = lengths.detach().to("cpu").to(torch.int64).clamp(0, T)
        order = torch.argsort(-lens, stable=True)
        sl = lens[order]
        nz = int((sl > 0).sum())
        self.T, self.N, self.nz = T, N, nz
        self.max_len = int(sl[0]) if nz else 0
        order_nz = order[:nz]
        steps = torch.arange(self.max_len)
        valid = steps[:, None] < sl[None, :nz]
        self.batch_sizes = valid.sum(1).to(torch.int64)
        idx = (steps[:, None] * N + order_nz[None, :])[valid]
        self.idx = idx.to(device)
        self.rows = order_nz.to(device)

    def pack(self, x):
        return x.reshape(self.T * self.N, -1).index_select(0, self.idx)

    def unpack(self, y):
        out = y.new_zeros(self.T * self.N, y.shape[-1])
        return out.index_copy(0, self.idx, y).view(self.T, self.N, -1)


def _torch_call(mode, x, hx, weights, num_layers, ndir, packing):
    """One torch RNN call over ``num_layers`` layers: ``x`` (T, N, F)
    padded (or packed by ``packing``); ``hx`` h (and c) for this call's
    layers.  Returns (out padded, h_n, c_n or None)."""
    fn = _vf(mode)
    train = torch.is_grad_enabled() and any(
        t.requires_grad for t in [x, *weights, *hx])
    bidir = ndir == 2
    if packing is not None:
        if packing.nz == 0:          # every row is empty: nothing runs
            T, N = packing.T, packing.N
            P = hx[0].shape[-1]
            return (x.new_zeros(T, N, ndir * P), hx[0],
                    hx[1] if len(hx) > 1 else None)
        hs = [h.index_select(1, packing.rows) for h in hx]
        args = (packing.pack(x), packing.batch_sizes,
                hs if mode == "lstm" else hs[0], weights, True, num_layers,
                0.0, train, bidir)
        res = fn(*args)
        out = packing.unpack(res[0])
        h_n = hx[0].index_copy(1, packing.rows, res[1])
        c_n = (hx[1].index_copy(1, packing.rows, res[2])
               if mode == "lstm" else None)
        return out, h_n, c_n
    res = fn(x, list(hx) if mode == "lstm" else hx[0], weights, True,
             num_layers, 0.0, train, bidir, False)
    return res[0], res[1], res[2] if mode == "lstm" else None


def run_cells(mode, x, h0, c0, cells, lengths=None, p=0.0,
              clip_min=None, clip_max=None):
    """The fused form over per-(layer, direction) weights ``cells[l][d]
    = (W, R, bW, bR, Wp or None)``: ``x`` (T, N, I), ``h0`` (L·D, N, P),
    ``c0`` (L·D, N, H) for LSTM (else ignored), ``lengths`` (N,) or
    None.  Returns (out (T, N, D·P), h_n, c_n or None)."""
    L, D = len(cells), len(cells[0])
    if x.device.type not in ("cpu", "cuda"):
        raise MXNetError(f"RNN: no path for a tensor on {x.device}")
    packing = (_Packing(lengths, x.shape[0], x.shape[1], x.device)
               if lengths is not None else None)
    groups = [list(range(L))] if p <= 0 else [[layer] for layer in range(L)]
    hs, cs = [], []
    for group in groups:
        weights = []
        for layer in group:
            for d in range(D):
                W, R, bW, bR, Wp = cells[layer][d]
                weights += [W, R, bW, bR] + ([Wp] if Wp is not None else [])
        rows = slice(group[0] * D, (group[-1] + 1) * D)
        hx = [h0[rows]] + ([c0[rows]] if mode == "lstm" else [])
        x, h_n, c_n = _torch_call(mode, x, hx, weights, len(group), D,
                                  packing)
        hs.append(h_n)
        if c_n is not None:
            cs.append(c_n)
        if p > 0 and group[-1] < L - 1:
            x = _dropout(x, p)
    h = hs[0] if len(hs) == 1 else torch.cat(hs, 0)
    if mode != "lstm":
        return x, h, None
    c = cs[0] if len(cs) == 1 else torch.cat(cs, 0)
    return x, h, _clip_cells(c, clip_min, clip_max)


# -- the plain form: the reference's step, looped over T ----------------------

def _step(mode):
    if mode in ("rnn_relu", "rnn_tanh"):
        act = torch.tanh if mode == "rnn_tanh" else torch.relu

        def step(x_t, h, c, W, R, bW, bR, Wp):
            return act(x_t @ W.t() + bW + h @ R.t() + bR), c
        return step
    if mode == "lstm":
        def step(x_t, h, c, W, R, bW, bR, Wp):
            i, f, g, o = (x_t @ W.t() + bW + h @ R.t() + bR).chunk(4, -1)
            new_c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            new_h = torch.sigmoid(o) * torch.tanh(new_c)
            if Wp is not None:
                new_h = new_h @ Wp.t()
            return new_h, new_c
        return step
    if mode == "gru":
        def step(x_t, h, c, W, R, bW, bR, Wp):
            ir, iz, inn = (x_t @ W.t() + bW).chunk(3, -1)
            hr, hz, hn = (h @ R.t() + bR).chunk(3, -1)
            r = torch.sigmoid(ir + hr)
            z = torch.sigmoid(iz + hz)
            n = torch.tanh(inn + r * hn)
            return (1 - z) * n + z * h, c
        return step
    raise ValueError(f"unknown RNN mode {mode!r}")


def _scan_dir(mode, x, h, c, W, R, bW, bR, Wp, lengths, reverse):
    step = _step(mode)
    T = x.shape[0]
    if reverse and lengths is not None:
        # each row's valid prefix reversed, so that the backward
        # direction starts at the row's last valid step
        ts = torch.arange(T, device=x.device)[:, None]
        idx = torch.where(ts < lengths[None, :], lengths[None, :] - 1 - ts,
                          ts)
        x = torch.take_along_dim(x, idx[:, :, None], dim=0)
        order = range(T)
    else:
        order = range(T - 1, -1, -1) if reverse else range(T)
    outs = [None] * T
    for t in order:
        new_h, new_c = step(x[t], h, c, W, R, bW, bR, Wp)
        if lengths is not None:
            valid = (t < lengths)[:, None]
            new_h = torch.where(valid, new_h, h)
            if c is not None:
                new_c = torch.where(valid, new_c, c)
            outs[t] = torch.where(valid, new_h, torch.zeros_like(new_h))
        else:
            outs[t] = new_h
        h, c = new_h, new_c
    out = torch.stack(outs, 0)
    if reverse and lengths is not None:
        out = torch.take_along_dim(out, idx[:, :, None], dim=0)
    return out, h, c


def cells_plain(mode, x, h0, c0, cells, lengths=None, p=0.0,
                clip_min=None, clip_max=None):
    """:func:`run_cells`'s function, as the reference computes it: each
    (layer, direction) a loop of the cell step over T."""
    L, D = len(cells), len(cells[0])
    if lengths is not None:
        lengths = lengths.to(torch.int64)
    hs, cs = [], []
    for layer in range(L):
        outs = []
        for d in range(D):
            W, R, bW, bR, Wp = cells[layer][d]
            s = layer * D + d
            c_in = c0[s] if mode == "lstm" else None
            out, h_T, c_T = _scan_dir(mode, x, h0[s], c_in, W, R, bW, bR,
                                      Wp, lengths, reverse=d == 1)
            outs.append(out)
            hs.append(h_T)
            cs.append(c_T)
        x = outs[0] if D == 1 else torch.cat(outs, -1)
        if p > 0 and layer < L - 1:
            x = _dropout(x, p)
    h = torch.stack(hs, 0)
    if mode != "lstm":
        return x, h, None
    return x, h, _clip_cells(torch.stack(cs, 0), clip_min, clip_max)


# -- the op -------------------------------------------------------------------

def _op(run, data, parameters, state, extra, state_size, num_layers, mode,
        bidirectional, p, state_outputs, use_sequence_length,
        lstm_state_clip_min, lstm_state_clip_max, projection_size):
    if projection_size is not None and mode != "lstm":
        raise ValueError("projection_size is LSTM-only (rnn-inl.h CHECK)")
    extra = list(extra)
    state_cell = extra.pop(0) if mode == "lstm" and extra else None
    lengths = extra.pop(0) if use_sequence_length and extra else None
    if extra:
        raise MXNetError(
            "RNN: the port takes no dropout key input; its inter-layer "
            "dropout draws from mx.random (seed it with mx.random.seed)")
    ndir = 2 if bidirectional else 1
    T, N, input_size = data.shape
    H = state_size
    P = projection_size if projection_size is not None else H
    cells = _slice_params(parameters, mode, input_size, H, num_layers, ndir,
                          projection_size)
    h0 = state.reshape(num_layers * ndir, N, P)
    c0 = (state_cell.reshape(num_layers * ndir, N, H)
          if state_cell is not None
          else data.new_zeros(num_layers * ndir, N, H))
    out, h, c = run(mode, data, h0, c0, cells, lengths, p,
                    lstm_state_clip_min, lstm_state_clip_max)
    if not state_outputs:
        return (out,)
    if mode == "lstm":
        return out, h, c
    return out, h


@register("RNN", aliases=("rnn",))
def rnn(data, parameters, state, *extra, state_size, num_layers,
        mode="lstm", bidirectional=False, p=0.0, state_outputs=False,
        use_sequence_length=False, lstm_state_clip_min=None,
        lstm_state_clip_max=None, lstm_state_clip_nan=False,
        projection_size=None):
    """Fused multi-layer (bi)directional RNN (``mxnet_tpu/ops/rnn.py:
    158``): ``data`` (T, N, I), the flat ``parameters``, ``state``
    (L·D, N, P), then ``state_cell`` (LSTM) and ``sequence_length``
    (``use_sequence_length``).  Returns ``(out,)``, or with
    ``state_outputs`` ``(out, h_n[, c_n])``.  One torch RNN call (a
    call per layer when ``p > 0``); see the module docstring."""
    return _op(run_cells, data, parameters, state, extra, state_size,
               num_layers, mode, bidirectional, p, state_outputs,
               use_sequence_length, lstm_state_clip_min,
               lstm_state_clip_max, projection_size)


def rnn_plain(data, parameters, state, *extra, state_size, num_layers,
              mode="lstm", bidirectional=False, p=0.0, state_outputs=False,
              use_sequence_length=False, lstm_state_clip_min=None,
              lstm_state_clip_max=None, lstm_state_clip_nan=False,
              projection_size=None):
    """:func:`rnn`'s function by the reference's step loop (the
    oracle)."""
    return _op(cells_plain, data, parameters, state, extra, state_size,
               num_layers, mode, bidirectional, p, state_outputs,
               use_sequence_length, lstm_state_clip_min,
               lstm_state_clip_max, projection_size)


def flat_cells(params: List[torch.Tensor], mode, ndir,
               projection=False) -> List[List[tuple]]:
    """Per-(layer, direction) cells from a Gluon layer's parameter list
    in its order (``[i2h_weight, h2h_weight, i2h_bias, h2h_bias(,
    h2r_weight)]`` for ``l0``, ``r0``, ``l1``, ...)."""
    per = 5 if projection else 4
    cells = []
    for i in range(0, len(params), per * ndir):
        row = []
        for d in range(ndir):
            w = params[i + d * per:i + (d + 1) * per]
            row.append((w[0], w[1], w[2], w[3],
                        w[4] if projection else None))
        cells.append(row)
    return cells
