"""SPMDTrainer on one device (counterpart of
``mxnet_tpu/parallel/trainer.py``).

One training step is forward, loss, gradients through
``torch.autograd`` and the optimizer's update op for every parameter:
the reference's ``_make_step_fn``.  The reference compiles it into one
donated jit executable per (data shape, dtype, label shape, dtype)
signature.  Here, on a CUDA device, it is captured as one CUDA graph per
signature (:class:`~mxnet_tpu_torch.executable.Executable`, warmed by
the signature's first call, which is a real step), and every later call
of the signature replays it.  ``run_steps`` replays the step's graph n
times; ``predict`` replays a forward captured per input signature.  On
the CPU (``device="cpu"``, which only the tests ask for) the same
functions run uncaptured.

The arithmetic is the reference's:

* ``dtype="bfloat16"`` computes in bf16 while the master weights stay
  f32: each floating parameter is cast *inside* the differentiated
  graph, so gradients arrive in f32 on the masters; floating input data
  is cast too (integer token ids are not);
* the loss mean is taken in f32;
* ``remat``: ``torch.utils.checkpoint`` (non-reentrant) around the loss
  function, as ``jax.checkpoint(loss_of)``: the forward is recomputed
  in the backward instead of keeping its activations;
* ``micro_batches`` k: the batch is cut into k along ``batch_axis``
  (arrays of lower rank along axis 0); the gradients are summed and
  divided by k, and the loss is the mean of the k losses;
* ``data_transform`` is applied to the data inside the step (and in
  ``predict``);
* each parameter's update is the optimizer's op with ``lr·lr_mult`` and
  ``wd·wd_mult``, ``rescale_grad`` 1 and the optimizer's clip — for
  Adam that means no bias correction — applied through the op's
  multi-tensor form, one call per group of equal multipliers.  lr and
  wd are 0-d f32 tensors on the device, written with the inputs before
  each call, so an lr schedule needs no new capture; the products with
  the multipliers are taken in f32 on the device;
* ``run_steps`` reads lr and wd once for the whole window and advances
  ``num_update`` by n, as the reference's fused window does;
* auxiliary states (BatchNorm's running statistics) are the reference's
  aux channel (``parallel/trainer.py:229-274, :407-415``): the forward
  hands their new values, computed from the compute-dtype copies the
  step began with, to a trace context (``gluon.block._TraceContext``)
  instead of writing them; the step copies them into the masters, cast
  to the masters' dtype, once, after the update.  Under
  ``micro_batches`` every micro-batch reads the stats the step began
  with and the last one's values are kept; under ``remat`` the
  recomputation in the backward writes nothing.  ``predict`` runs in
  eval mode and writes nothing.

Masters and optimizer state are updated in place (``copy_``), which the
reference expresses as buffer donation (``donate`` is accepted; updates
are always in place).  A graph holds their addresses: before each call
the trainer compares them with those its graphs were captured on, and
when a master or a state has been replaced by another tensor
(``Parameter._set``, re-initialisation) it drops every graph and
captures again.

Under the AMP policy (``amp.init`` or ``MXNET_AMP=1``,
``mxnet_tpu/parallel/trainer.py:124-137, 244-275, 360-408``) the compute
dtype comes from the policy when ``dtype`` is not given, and a dynamic
loss scaler (``amp.LossScaler``, initial scale 1.0 for bf16, 2**16 for
fp16) runs inside the step: its scale and clean-step count are device
tensors of the trainer that the captured step reads and writes.  The
loss is multiplied by the scale, the gradients by its inverse, one
all-finite reduction covers every gradient, and the gradients take the
``wire_cast`` round trip through the storage dtype; the update is then
applied or skipped by ``torch.where`` on that device bool (a graph has
no ``lax.cond``), and the scale grows after ``scale_window`` clean steps
or halves (to no less than 1) on an overflow.  Auxiliary states are
written either way, as in the reference.  The new scale, count and
skipped steps go to the scaler through ``adopt_traced``, read on the
host one call later: nothing inside a step or a ``run_steps`` window
reads the host.  A scale set on the host (``loss_scale = ...``,
``load_state``) is written into the device state before the next call.

The embedding's id range check is deferred (``ops.tensor.IdCheck``):
the ids are clamped on the device and their range recorded there.  On
CUDA the trainer raises the eager check's :class:`MXNetError` at the
entry of its next call (waiting for the previous call's work); on the
CPU at once.

A mesh, ZeRO and ``seq_axis`` are not ported yet and raise.
"""
from __future__ import annotations

import contextlib
import time
from functools import partial
from typing import Callable, Optional

import numpy as onp
import torch
from torch.utils.checkpoint import checkpoint

from .. import autograd as ag
from .. import optimizer as opt_mod
from .. import telemetry, tracing
from ..base import MXNetError
from ..context import resolve_device
from ..amp import policy as _amp_policy
from ..amp.loss_scaler import LossScaler, all_finite
from ..executable import Executable, input_spec
from ..gluon.block import _TraceContext
from ..ops import optimizer_ops
from ..ops.tensor import IdCheck

__all__ = ["SPMDTrainer"]

_LOW_PRECISION = ("bfloat16", "bf16", "float16")


@contextlib.contextmanager
def _params_as(params, tensors):
    """Let each parameter's ``data()`` return the given tensor inside the
    scope (the compute-dtype copies of a step)."""
    try:
        for p, t in zip(params, tensors):
            p._override = t
        yield
    finally:
        for p in params:
            p._override = None


def _batch(x):
    return x if isinstance(x, torch.Tensor) else onp.asarray(x)


def _times(t, mult):
    """A 0-d f32 device tensor times a Python multiplier, in f32."""
    return t if mult == 1.0 else t * mult


class SPMDTrainer:
    def __init__(self, net, loss_fn: Callable, optimizer="sgd",
                 optimizer_params: Optional[dict] = None, mesh=None,
                 batch_axis: int = 0, donate: bool = True,
                 dtype: Optional[str] = None, remat: bool = False,
                 seq_axis: Optional[int] = None, micro_batches: int = 1,
                 zero_stage: Optional[int] = None,
                 data_transform: Optional[Callable] = None,
                 zero: Optional[int] = None, device=None):
        unported = [name for name, on in (
            ("mesh", mesh is not None), ("seq_axis", seq_axis is not None),
            ("zero_stage", bool(zero_stage) or bool(zero))) if on]
        if unported:
            raise MXNetError(f"SPMDTrainer: {', '.join(unported)} not "
                             f"ported yet; the port trains on one device")
        if micro_batches < 1:
            raise MXNetError("micro_batches must be >= 1")
        self.device = resolve_device(device)
        self.net = net
        self.loss_fn = loss_fn
        self.batch_axis = int(batch_axis)
        self.remat = bool(remat)
        self.micro_batches = int(micro_batches)
        self._data_transform = data_transform
        self.amp_dtype = torch.bfloat16 if dtype in _LOW_PRECISION else None
        # the AMP policy: its compute dtype when dtype is not given, and a
        # dynamic loss scaler whose state lives on the device
        self._amp_scaler = None
        if _amp_policy.enabled():
            if self.amp_dtype is None:
                self.amp_dtype = _amp_policy.compute_dtype()
            half = _amp_policy.compute_dtype_str() == "float16"
            self._amp_scaler = LossScaler(
                init_scale=2.0 ** 16 if half else 1.0)
            # (scale, clean steps, skipped steps of the call) on the device
            self._amp_state = tuple(
                torch.zeros((), dtype=torch.float32, device=self.device)
                for _ in range(3))
            self._amp_version = None
        self.optimizer = opt_mod.create(optimizer,
                                        **(optimizer_params or {}))
        self._update = getattr(optimizer_ops,
                               f"{self.optimizer.op_name}_multi")
        self._params = net.collect_params()
        self._pkeys = list(self._params.keys())
        self._plist = [self._params[k] for k in self._pkeys]
        for k, p in zip(self._pkeys, self._plist):
            p._check_initialized()
            if p.data().device != self.device:
                raise MXNetError(f"parameter {k} is on {p.data().device}, "
                                 f"the trainer on {self.device}")
        self._opt_state = {
            k: tuple(self.optimizer.create_state(i, self._params[k].data()))
            for i, k in enumerate(self._pkeys)}
        self.num_update = 0
        # signature -> (Executable, its IdCheck); the addresses of the
        # masters and states they were captured on
        self._exec = {}
        self._ptrs = None
        self.compiles = 0
        # the last call's deferred id check: (host bounds, vocabs, event)
        self._pending_ids = None
        # what the trainer's graphs share: a memory pool and a capture
        # stream
        self._capture_with = (None, None)
        if self.device.type == "cuda":
            with torch.cuda.device(self.device):
                self._capture_with = (torch.cuda.graph_pool_handle(),
                                      torch.cuda.Stream(self.device))

    # -- the functions a graph holds -----------------------------------------
    def _loss(self, masters, ids, aux, data, label):
        """The f32 loss mean of one batch (times the loss scale under
        AMP).  The masters are cast to the
        compute dtype here, inside the differentiated graph, and the
        thread-local state the forward reads (training mode, the id
        check, the aux channel) is set here too, so that remat's
        recomputation sees it wherever autograd runs it."""
        amp = self.amp_dtype
        compute = [w.to(amp) if amp is not None and w.is_floating_point()
                   else w for w in masters]
        if amp is not None and data.is_floating_point():
            data = data.to(amp)
        with _params_as(self._plist, compute), ag.train_mode(), ids, aux:
            out = self.net(data)
            loss = self.loss_fn(out, label).float().mean()
        if self._amp_scaler is not None:
            loss = loss * self._amp_state[0]
        return loss

    def _loss_and_grads(self, masters, live, ids, data, label):
        """``(loss, grads, aux)``: the gradients of the live masters, and
        the auxiliary states' new values (BatchNorm's running statistics)
        as the forward computed them, in the compute dtype.  The aux
        channel closes when the forward returns, so remat's recomputation
        in the backward writes nothing."""
        aux = _TraceContext()
        loss_of = partial(self._loss, masters, ids, aux)
        if self.remat:
            loss = checkpoint(loss_of, data, label, use_reentrant=False)
        else:
            loss = loss_of(data, label)
        aux.close()
        return (loss, torch.autograd.grad(loss, [masters[i] for i in live]),
                aux.aux)

    def _split(self, x):
        """``x`` cut into the micro-batches along the batch axis (axis 0
        for arrays of lower rank)."""
        ax = self.batch_axis if self.batch_axis < x.dim() else 0
        return x.split(x.shape[ax] // self.micro_batches, dim=ax)

    def _check_split(self, *arrays):
        k = self.micro_batches
        for x in arrays if k > 1 else ():
            ax = self.batch_axis if self.batch_axis < x.ndim else 0
            if x.shape[ax] % k:
                raise MXNetError(f"batch {x.shape[ax]} (axis {ax}) not "
                                 f"divisible by micro_batches={k}")

    def _train_body(self, ids, lr, wd, data, label):
        """One step on the (static) inputs: ``(loss, id bounds)``."""
        ids.reset()
        masters = [p.data() for p in self._plist]
        live = [i for i, p in enumerate(self._plist)
                if p.grad_req != "null"]
        if self._data_transform is not None:
            data = self._data_transform(data)
        k = self.micro_batches
        with torch.enable_grad():
            if k == 1:
                loss, grads, aux = self._loss_and_grads(masters, live, ids,
                                                        data, label)
            else:
                losses, grads = [], None
                for d, l in zip(self._split(data), self._split(label)):
                    li, g, aux = self._loss_and_grads(masters, live, ids, d,
                                                      l)
                    losses.append(li)
                    grads = list(g) if grads is None else \
                        torch._foreach_add(grads, g)
                grads = torch._foreach_div(grads, float(k))
                loss = torch.stack(losses).mean()
        finite = None
        if self._amp_scaler is not None:
            loss, grads, finite = self._amp_unscale(loss, grads)
        self._apply_updates(lr, wd, masters, live, grads, finite)
        self._write_aux(aux)
        if finite is not None:
            self._amp_advance(finite)
        return loss.detach(), ids.bounds()

    @torch.no_grad()
    def _amp_unscale(self, loss, grads):
        """``(loss, grads, finite)``: the loss and gradients times
        1/scale, one all-finite over the gradients (before the wire's
        rounding), then the gradients' round trip through the storage
        dtype."""
        inv = 1.0 / self._amp_state[0]
        loss = loss * inv
        grads = [g * inv.to(g.dtype) if g.is_floating_point() else g
                 for g in grads]
        finite = all_finite(grads)
        return loss, [_amp_policy.wire_cast(g) for g in grads], finite

    @torch.no_grad()
    def _amp_advance(self, finite):
        """The scaler's schedule on the device: grow after a window of
        clean steps, halve (to no less than 1) on an overflow; count the
        skipped step."""
        scale, good, skipped = self._amp_state
        factor = self._amp_scaler._scale_factor
        window = self._amp_scaler._scale_window
        good1 = good + 1.0
        grown = torch.where(good1 >= window, scale * factor, scale)
        new_scale = torch.where(finite, grown, torch.clamp(
            scale * (1.0 / factor), min=1.0))
        new_good = torch.where(finite, torch.where(good1 >= window, 0.0,
                                                   good1), 0.0)
        scale.copy_(new_scale)
        good.copy_(new_good)
        skipped.add_((~finite).float())

    def _amp_enter(self):
        """Before a call: the host's scale, if it was set there, into the
        device state; the call's skipped count to 0."""
        sc = self._amp_scaler
        if sc is None:
            return
        if self._amp_version != sc._version:
            sc._fold()
            self._amp_state[0].fill_(sc._loss_scale)
            self._amp_state[1].fill_(float(sc._unskipped))
            self._amp_version = sc._version
        self._amp_state[2].zero_()

    def _amp_leave(self):
        """After a call: the device state to the scaler (read one call
        later)."""
        if self._amp_scaler is not None:
            self._amp_scaler.adopt_traced(*self._amp_state)

    @torch.no_grad()
    def _write_aux(self, aux):
        """The auxiliary states' new values (the last micro-batch's, as
        the reference keeps them) copied in place into their masters, in
        the masters' dtype: once a step, after the update, at the
        masters' fixed addresses."""
        if aux:
            torch._foreach_copy_([p._data for p in aux], list(aux.values()))

    @torch.no_grad()
    def _apply_updates(self, lr, wd, masters, live, grads, finite=None):
        """Every live parameter's update, one multi-tensor call of the
        optimizer's op for each group of equal (lr_mult, wd_mult); masters
        and state are overwritten in place.  Under AMP each new value is
        ``torch.where(finite, new, old)``: an overflowing step writes back
        the old bits."""
        opt = self.optimizer
        statics = dict(opt.static_params(0))
        statics.setdefault("rescale_grad", 1.0)
        statics.setdefault("clip_gradient",
                           float(opt.clip_gradient)
                           if opt.clip_gradient is not None else -1.0)
        groups = {}
        for j, i in enumerate(live):
            p = self._plist[i]
            groups.setdefault((p.lr_mult, p.wd_mult), []).append((i, j))
        for (lr_mult, wd_mult), members in groups.items():
            weights = [masters[i] for i, _ in members]
            states = [self._opt_state[self._pkeys[i]] for i, _ in members]
            new_w, *new_states = self._update(
                weights, [grads[j] for _, j in members],
                *map(list, zip(*states)), lrs=_times(lr, lr_mult),
                wds=_times(wd, wd_mult), **statics)
            olds = [weights] + [[st[n] for st in states]
                                for n in range(len(new_states))]
            for old, new in zip(olds, [new_w, *new_states]):
                if finite is not None:
                    new = [torch.where(finite, a, b)
                           for a, b in zip(new, old)]
                torch._foreach_copy_(old, new)

    def _predict_body(self, ids, x):
        """The forward in eval mode: ``(f32 output, id bounds)``."""
        ids.reset()
        if self._data_transform is not None:
            x = self._data_transform(x)
        amp = self.amp_dtype
        with ag.pause():
            compute = [w.to(amp) if amp is not None and w.is_floating_point()
                       else w for w in (p.data() for p in self._plist)]
            if amp is not None and x.is_floating_point():
                x = x.to(amp)
            with _params_as(self._plist, compute), ids:
                out = self.net(x)
        return out.float(), ids.bounds()

    # -- executables -----------------------------------------------------------
    def _state_ptrs(self):
        return tuple(t.data_ptr() for k, p in zip(self._pkeys, self._plist)
                     for t in (p.data(), *self._opt_state[k]))

    def _executable(self, sig, body, args):
        """``(entry, fresh)``: the signature's executable and id check,
        made on its first call.  Graphs captured on masters or states
        that have since been replaced are dropped first."""
        ptrs = self._state_ptrs()
        if ptrs != self._ptrs:
            self._exec.clear()
            self._ptrs = ptrs
        entry = self._exec.get(sig)
        if entry is not None:
            return entry, False
        ids = IdCheck()
        ex = Executable(partial(body, ids), args, self.device,
                        *self._capture_with, warm="first_call")
        entry = self._exec[sig] = (ex, ids)
        self.compiles += 1
        return entry, True

    def _call(self, sig, entry, fresh, args):
        """Run the executable; a signature's first call (on CUDA the warm
        run and the capture) counts as its compile."""
        if not fresh:
            return entry[0](*args)
        t0 = time.perf_counter()
        try:
            out = entry[0](*args)
        except BaseException:
            self._exec.pop(sig, None)
            raise
        telemetry.record_compile(time.perf_counter() - t0, "spmd_step")
        return out

    def _defer_ids(self, bounds, vocabs):
        """On the CPU, raise now if an id was out of range; on CUDA, copy
        the bounds to the host behind the call's work, for the next
        call's :meth:`_check_ids`."""
        if bounds is None:
            return
        if self.device.type == "cpu":
            IdCheck.raise_if_bad(bounds, vocabs)
            return
        host = torch.empty(bounds.shape, dtype=bounds.dtype,
                           pin_memory=True)
        host.copy_(bounds, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        self._pending_ids = (host, list(vocabs), done)

    def _check_ids(self):
        """Raise the previous call's embedding error, if it had one."""
        pending, self._pending_ids = self._pending_ids, None
        if pending is not None:
            host, vocabs, done = pending
            done.synchronize()
            IdCheck.raise_if_bad(host, vocabs)

    def _schedule(self, n_steps):
        """lr and wd (as f32) at the window's entry point, then advance
        ``num_update`` by ``n_steps``."""
        lr = onp.float32(self.optimizer.learning_rate)
        wd = onp.float32(self.optimizer.wd)
        self.num_update += n_steps
        self.optimizer.num_update = self.num_update
        return lr, wd

    def _step_sig(self, d, l):
        return ("step",) + input_spec(d) + input_spec(l) + (
            _amp_policy.cache_token(),)

    # -- entry points ------------------------------------------------------------
    def step(self, data, label, batch_size: Optional[int] = None):
        """One training step; returns the f32 loss mean (a 0-d tensor on
        the device, a copy: the next call does not overwrite it)."""
        self._check_ids()
        d, l = _batch(data), _batch(label)
        self._check_split(d, l)
        sig = self._step_sig(d, l)
        tok = telemetry.begin_step()
        try:
            with tracing.span("step.spmd") as sp:
                lr, wd = self._schedule(1)
                sp.annotate(step=self.num_update)
                entry, fresh = self._executable(sig, self._train_body,
                                                (lr, wd, d, l))
                self._amp_enter()
                with tracing.span("compile.spmd_step" if fresh
                                  else "step.dispatch"):
                    loss, bounds = self._call(sig, entry, fresh,
                                              (lr, wd, d, l))
                self._amp_leave()
                sp.annotate(fresh_compile=fresh)
                loss = loss.clone()
                self._defer_ids(bounds, entry[1].vocabs)
        finally:
            telemetry.end_step(tok, "SPMDTrainer")
        return loss

    def run_steps(self, data, label, n_steps: int,
                  per_step_data: bool = False):
        """``n_steps`` training steps at one lr/wd, replaying the step's
        graph; returns their losses as an (n_steps,) tensor.  With
        ``per_step_data``, data and label carry a leading ``n_steps`` axis
        and step i trains on batch i: the window goes to the device in
        one copy each, and batch i is copied device to device into the
        graph's inputs."""
        self._check_ids()
        d, l = _batch(data), _batch(label)
        n = int(n_steps)
        if per_step_data:
            if d.shape[0] != n or l.shape[0] != n:
                raise MXNetError(
                    f"run_steps(per_step_data=True): leading axis must be "
                    f"n_steps={n}, got data {tuple(d.shape)} label "
                    f"{tuple(l.shape)}")
            d, l = self._on_device(d), self._on_device(l)
            batches = [(d[i], l[i]) for i in range(n)]
        else:
            batches = [(d, l)] * n
        self._check_split(*batches[0])
        sig = self._step_sig(*batches[0])
        tok = telemetry.begin_step()
        try:
            with tracing.span("step.spmd_window", n_steps=n,
                              step=self.num_update + 1):
                lr, wd = self._schedule(n)
                entry, fresh = self._executable(
                    sig, self._train_body, (lr, wd) + batches[0])
                losses = torch.empty((n,), dtype=torch.float32,
                                     device=self.device)
                bounds = []
                self._amp_enter()
                for i, (di, li) in enumerate(batches):
                    with tracing.span("compile.spmd_step" if fresh
                                      else "step.dispatch"):
                        loss, b = self._call(sig, entry, fresh,
                                             (lr, wd, di, li))
                    fresh = False
                    losses[i] = loss
                    if b is not None:
                        bounds.append(b.clone())
                self._amp_leave()
                if bounds:
                    self._defer_ids(torch.cat(bounds), entry[1].vocabs * n)
        finally:
            telemetry.end_step(tok, "SPMDTrainer", extra={"n_steps": n})
        return losses

    def predict(self, data):
        """The forward in eval mode with f32 output (a copy), on CUDA
        replayed from one graph per input signature that shares the
        trainer's pool and stream."""
        self._check_ids()
        x = _batch(data)
        sig = ("predict",) + input_spec(x) + (_amp_policy.cache_token(),)
        entry, fresh = self._executable(sig, self._predict_body, (x,))
        out, bounds = self._call(sig, entry, fresh, (x,))
        out = out.clone()
        self._defer_ids(bounds, entry[1].vocabs)
        return out

    # -- eager runs of the same functions, for comparisons -----------------------
    def _on_device(self, x):
        if isinstance(x, torch.Tensor):
            return x.to(self.device)
        return torch.as_tensor(onp.asarray(x), device=self.device)

    def _step_eager(self, data, label):
        """One step run eagerly (never captured) through the function a
        step's graph holds; an id out of range raises at once."""
        self._check_ids()
        d, l = self._on_device(data), self._on_device(label)
        self._check_split(d, l)
        lr, wd = (torch.tensor(v, device=self.device)
                  for v in self._schedule(1))
        ids = IdCheck()
        self._amp_enter()
        loss, bounds = self._train_body(ids, lr, wd, d, l)
        self._amp_leave()
        if bounds is not None:
            IdCheck.raise_if_bad(bounds.cpu(), ids.vocabs)
        return loss

    def _predict_eager(self, data):
        """``predict`` run eagerly through the function its graph holds."""
        self._check_ids()
        ids = IdCheck()
        out, bounds = self._predict_body(ids, self._on_device(data))
        if bounds is not None:
            IdCheck.raise_if_bad(bounds.cpu(), ids.vocabs)
        return out
