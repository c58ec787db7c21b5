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

Persistence (``mxnet_tpu/parallel/trainer.py:1025-1317``):
``save_states`` / ``load_states`` (the ``mxnet_tpu-trainer-states-v1``
npz, no pickle), ``save_checkpoint`` / ``load_checkpoint`` through the
async checkpoint service (``checkpoint.py``: the tree is ``param/<k>``
and ``opt/<k>/<i>``, the header ``num_update``, ``slots``, ``meta``,
``mesh_axes`` and, under AMP, the scaler's state), and ``fit`` with its
auto-resume.  A load writes into the existing masters, optimizer states
and AMP state in place (``copy_``): the graphs captured before it stay
valid, and the next step replays one of them.  The header's ``rng_key``
stands for ``mx.random``'s state as the save found it, in the
reference's two-word key format (``ops/random.py`` ``key_words``: the
reference reads that entry as its JAX key, and resumes from the port's
checkpoint), and ``rng_state`` is that state whole
(``get_state_bits``).  A load restores ``rng_state``, so a resumed run
draws the Dropout masks the uninterrupted run would have drawn; from the
reference's checkpoint, which has only its key, it seeds every
generator from the key.

Randomness (``mxnet_tpu/parallel/trainer.py:246-254, :568-577``): the
forward draws through its trace context (``gluon.block._TraceContext``,
``mx.random``'s trace hook inside the step), from the device's
generator.  A captured step registers that generator with its graph, so
each replay (each step of ``run_steps`` too) draws fresh masks from the
generator's state at that moment, bitwise as ``_step_eager`` from the
same state would; remat's recomputation is handed the forward's own
draws.  On a mesh every rank draws the whole batch's mask and keeps its
part, so ranks seeded alike drop what one device would.

With a mesh (``mesh=make_mesh(...)`` or a ``MeshPlan``; with none,
``MXNET_MESH``, else every rank of a started process group over dp) the
trainer is one rank of an SPMD job over ``torch.distributed``
(``parallel/spmd.py``): each rank trains on its shard of the batch
(``batch_axis`` over dp, ``seq_axis`` over sp; BatchNorm takes the
statistics of the whole batch, summed over those axes), holds its
shards of the parameters its specs cut (``Parameter.shard``, over any
mesh axis) and, under ZeRO
(``zero_stage`` / ``zero`` 1–3, default ``MXNET_ZERO``), its dp chunk of
the optimizer state (stage 3: of the master too), and makes the step's
collectives inside the step.  Every rank passes the same whole batch, as
to the reference.  A sharded parameter's full value is stale while the
trainer holds its shards: :meth:`gather_params` (collective) writes it
back.  On one rank (a plain ``python`` run: a group of one) nothing is
sharded and no collective runs, so the step is the unmeshed one.  A
trainer sharded over ranks persists on every rank (the calls are
collective): ``save_checkpoint`` has each rank write its own boxes of the
whole values through the checkpoint service's commit barrier and
``load_checkpoint`` has each read back only its boxes, so neither
gathers the state anywhere, and a save restores onto any mesh shape;
``save_states`` gathers one state at a time and rank 0 streams it into
the npz, and ``load_states`` has each rank cut its part from the file.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from functools import partial
from typing import Callable, Optional

import numpy as onp
import torch
from torch.utils.checkpoint import checkpoint

from .. import autograd as ag
from .. import optimizer as opt_mod
from .. import profiler, telemetry, tracing
from ..base import MXNetError, numpy_bits, tensor_from_bits
from ..context import resolve_device
from ..amp import policy as _amp_policy
from ..amp.loss_scaler import (LossScaler, advance_device, all_finite,
                               device_state, enter_device)
from ..executable import CaptureOwner, Executable, input_spec
from ..ops import random as _rng
from ..gluon.block import _TraceContext
from ..imperative.cached_step import ensure_real
from ..ndarray.ndarray import NDArray
from ..ops import optimizer_ops
from ..ops.tensor import IdCheck
from . import collectives as comm
from . import tensor_parallel as _tp

__all__ = ["SPMDTrainer"]

_LOW_PRECISION = ("bfloat16", "bf16", "float16")


@contextlib.contextmanager
def _params_as(params, tensors):
    """Let each parameter's ``_tensor()`` return the given tensor inside the
    scope (the compute-dtype copies of a step)."""
    try:
        for p, t in zip(params, tensors):
            p._override = t
        yield
    finally:
        for p in params:
            p._override = None


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
        if micro_batches < 1:
            raise MXNetError("micro_batches must be >= 1")
        if zero_stage is None:
            zero_stage = zero
        if zero_stage is None:
            from ..optimizer.fused_step import zero_enabled
            zero_stage = 1 if zero_enabled() else 0
        if zero_stage not in (0, 1, 2, 3):
            raise MXNetError("zero_stage must be 0, 1, 2 or 3")
        self.zero_stage = int(zero_stage)
        self.seq_axis = seq_axis
        self.plan = None
        mesh = self._resolve_mesh(mesh)
        self.mesh = mesh
        if mesh is not None:
            if device is not None and resolve_device(device) != mesh.device:
                raise MXNetError(f"SPMDTrainer: device {device} differs "
                                 f"from this rank's mesh device "
                                 f"{mesh.device}")
            device = mesh.device
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
            self._amp_state = device_state(self.device)
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
            if p._tensor().device != self.device:
                raise MXNetError(f"parameter {k} is on {p._tensor().device}, "
                                 f"the trainer on {self.device}")
        self._mesh_run = None
        if mesh is not None:
            from .spmd import MeshRun
            self._mesh_run = MeshRun(mesh, self.plan, self.net, self._plist,
                                     self._pkeys, self.batch_axis, seq_axis,
                                     self.zero_stage, self.micro_batches)
            self._mesh_run.take()
        views = self._state_views(self._masters())
        self._opt_state = {
            k: tuple(self.optimizer.create_state(i, views[i]))
            for i, k in enumerate(self._pkeys)}
        self.num_update = 0
        # signature -> (Executable, its IdCheck); the addresses of the
        # masters and states they were captured on
        self._exec = {}
        self._ptrs = None
        self.compiles = 0
        # what the trainer's graphs share (a memory pool and a capture
        # stream), and the last call's deferred id check
        self._owner = CaptureOwner()

    # -- the mesh ----------------------------------------------------------------
    def _resolve_mesh(self, mesh):
        """The trainer's Mesh, or None for the single-device trainer: a
        ``MeshPlan``'s mesh; with none given, ``MXNET_MESH``'s plan, else
        every rank of a started group of more than one over dp (the
        reference's ``default_mesh``)."""
        from . import _dist
        from .mesh import Mesh, default_mesh
        from .mesh4d import MeshPlan, mesh_plan_from_env
        if isinstance(mesh, MeshPlan):
            self.plan = mesh
            return mesh.mesh
        if mesh is None:
            self.plan = mesh_plan_from_env()
            if self.plan is not None:
                return self.plan.mesh
            if _dist.world_size() > 1:
                return default_mesh()
            return None
        if not isinstance(mesh, Mesh):
            raise MXNetError(f"SPMDTrainer: mesh must be a parallel.Mesh "
                             f"or MeshPlan, got {type(mesh).__name__}")
        return mesh

    def _masters(self):
        """The tensors the step differentiates and updates: this rank's
        masters (each parameter's own tensor unless the mesh shards
        it)."""
        if self._mesh_run is None:
            return [p._tensor() for p in self._plist]
        return self._mesh_run.master_list()

    def _state_views(self, masters):
        """What the optimizer updates of each master (ZeRO-1/2: this
        rank's chunk, a view)."""
        if self._mesh_run is None:
            return list(masters)
        return [lay.state_view(m) for lay, m in
                zip(self._mesh_run.layouts, masters)]

    @torch.no_grad()
    def gather_params(self):
        """Write every sharded parameter's full value back into it, from
        the ranks' shards (collective: every rank of the mesh calls it).
        The parameters read as usual until the next step."""
        run = self._mesh_run
        if run is None:
            return
        for i, lay in enumerate(run.layouts):
            if not lay.sharded:
                continue
            p = lay.param
            full = run.full_value(i, run.masters[i])
            st = p._data.untyped_storage()
            if st.nbytes() == 0:
                st.resize_(p._data.numel() * p._data.element_size())
            p._data.copy_(full)
            p._shard_state = "gathered"

    def _stale_after_step(self):
        """A step leaves every sharded parameter's full value stale."""
        run = self._mesh_run
        if run is not None:
            for lay in run.layouts:
                if lay.sharded:
                    lay.param._shard_state = "stale"

    @torch.no_grad()
    def set_full_value(self, param, data):
        """Load the whole value of one of the trainer's parameters (e.g.
        the reference's weights, ``convert.load_collected_params(...,
        trainer=)``): a parameter the mesh shards keeps this rank's shard
        of it in its master, its full tensor stale until
        ``gather_params``; any other takes ``set_data``."""
        if param._shard_state is None:
            param.set_data(data)
            return
        run = self._mesh_run
        i = next(j for j, p in enumerate(self._plist) if p is param)
        data = torch.as_tensor(data).to(self.device, run.masters[i].dtype)
        if tuple(data.shape) != run.layouts[i].shape:
            raise MXNetError(f"set_full_value: shape {tuple(data.shape)} "
                             f"!= {run.layouts[i].shape} of {param.name}")
        run.masters[i].copy_(run.layouts[i].local_of(data))
        param._shard_state = "stale"

    def gather_states(self):
        """``{key: (full state tensors)}``: the optimizer state of every
        parameter as one device would hold it (collective on a mesh)."""
        run = self._mesh_run
        out = {}
        for i, k in enumerate(self._pkeys):
            st = self._opt_state[k]
            out[k] = tuple(st) if run is None else tuple(
                run.full_value(i, t) for t in st)
        return out

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
        run = self._mesh_run
        with self._mesh_scope(step=True):
            if run is not None:
                compute = run.compute(compute)
            with _params_as(self._plist, compute), ag.train_mode(), ids, \
                    aux:
                out = self.net(data)
                loss = self.loss_fn(out, label).float().mean()
        if run is not None:
            loss = run.scale_loss(loss)
        if self._amp_scaler is not None:
            loss = loss * self._amp_state[0]
        return loss

    def _mesh_scope(self, step):
        """The scope the layers read inside a meshed forward: the step's
        (its batch is this rank's shard) or ``predict``'s (the whole batch
        on every rank)."""
        run = self._mesh_run
        if run is None:
            return contextlib.nullcontext()
        return _tp.scope(run.mesh, step and run.sp is not None, run.tp_local,
                         batch_axes=run.batch_axes if step else ())

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
        masters = self._masters()
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
        run = self._mesh_run
        if run is not None:
            with torch.no_grad():
                grads = run.reduce_grads(grads, live)
                loss = run.global_loss(loss)
        finite = None
        if self._amp_scaler is not None:
            loss, grads, finite = self._amp_unscale(loss, grads)
            if run is not None:
                finite = run.agree(finite)
        self._apply_updates(lr, wd, self._state_views(masters), live, grads,
                            finite)
        if run is not None:
            with torch.no_grad():
                run.gather_updated(masters)
        self._write_aux(aux)
        if finite is not None:
            sc = self._amp_scaler
            advance_device(self._amp_state, finite, sc._scale_factor,
                           sc._scale_window)
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

    def _amp_enter(self):
        """Before a call: the host's scale, if it was set there, into the
        device state; the call's skipped count to 0."""
        sc = self._amp_scaler
        if sc is None:
            return
        self._amp_version = enter_device(self._amp_state, sc,
                                         self._amp_version)

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
        with ag.pause(), self._mesh_scope(step=False):
            compute = [w.to(amp) if amp is not None and w.is_floating_point()
                       else w for w in self._masters()]
            if self._mesh_run is not None:
                compute = self._mesh_run.compute(compute)
            if amp is not None and x.is_floating_point():
                x = x.to(amp)
            with _params_as(self._plist, compute), ids:
                out = self.net(x)
        return out.float(), ids.bounds()

    # -- executables -----------------------------------------------------------
    def _state_ptrs(self):
        return tuple(t.data_ptr() for k, m in zip(self._pkeys,
                                                  self._masters())
                     for t in (m, *self._opt_state[k]))

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
                        *self._owner.capture_with(self.device),
                        warm="first_call")
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
            with comm.tally() as moved:
                out = entry[0](*args)
        except BaseException:
            self._exec.pop(sig, None)
            raise
        if self._mesh_run is not None and sig[0] == "step":
            self._mesh_run.step_bytes = moved
        telemetry.record_compile(time.perf_counter() - t0, "spmd_step")
        return out

    def _schedule(self, n_steps):
        """lr and wd (as f32) at the window's entry point, then advance
        ``num_update`` by ``n_steps``."""
        lr = onp.float32(self.optimizer.learning_rate)
        wd = onp.float32(self.optimizer.wd)
        self.num_update += n_steps
        self.optimizer.num_update = self.num_update
        return lr, wd

    def _stage_input(self, x, lead=0):
        """One batch array for a call (``mxnet_tpu/parallel/trainer.py:
        627-644``): an NDArray's tensor, unwrapped with no host round
        trip; a tensor as it is; anything else as a numpy array.  A tensor
        already on the trainer's device is copied device to device into
        the executable's input (a batch the device prefetcher delivered);
        anything else is copied from the host inside the call, accounted
        in ``input.h2d_bytes`` and counted in ``input.step_h2d``.  On a
        mesh, this rank's shard of the batch (``lead`` leading window
        axes first)."""
        if isinstance(x, NDArray):
            ensure_real(x)
            x = x._data
        elif not isinstance(x, torch.Tensor):
            x = onp.asarray(x)
        if self._mesh_run is not None:
            self._last_tokens = _token_count(x, lead)
            x = self._mesh_run.local_batch(x, lead)
        if not (isinstance(x, torch.Tensor) and x.device == self.device):
            telemetry.record_h2d_bytes(x.nbytes, step_path=True)
        return x

    def _step_sig(self, d, l):
        return ("step",) + input_spec(d) + input_spec(l) + (
            _amp_policy.cache_token(),)

    # -- entry points ------------------------------------------------------------
    def step(self, data, label, batch_size: Optional[int] = None):
        """One training step; returns the f32 loss mean as a 0-d NDArray
        on the device (a copy: the next call does not overwrite it)."""
        self._owner.check_ids()
        d, l = self._stage_input(data), self._stage_input(label)
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
                t_op = profiler.op_timer()
                with tracing.span("compile.spmd_step" if fresh
                                  else "step.dispatch"):
                    loss, bounds = self._call(sig, entry, fresh,
                                              (lr, wd, d, l))
                    telemetry.record_dispatch()
                self._amp_leave()
                sp.annotate(fresh_compile=fresh)
                loss = loss.clone()
                self._owner.defer_ids(bounds, entry[1].vocabs, self.device)
                self._stale_after_step()
                self._account_step_telemetry(tok, 1)
            profiler.op_record("SPMDTrainer::step", t_op)
        finally:
            telemetry.end_step(tok, "SPMDTrainer")
        return NDArray._wrap(loss)

    def warm_start(self) -> int:
        """The reference loads serialized step executables from its
        artifact store here (``mxnet_tpu/parallel/trainer.py:515-540``).
        The port has none to load: a step's CUDA graph cannot leave the
        process that captured it, and its kernels and their tuning are
        cached on disk already.  Returns 0, and logs why."""
        from ..log import get_logger
        get_logger("mxnet_tpu_torch.parallel").warning(
            "warm_start: 0 executables loaded; a captured step lives in "
            "its process (the first step captures it), and the kernels "
            "and their tuning are cached on disk already")
        return 0

    # the reference's cost_analysis keys that torch has no counterpart
    # for (XLA's cost model and buffer assignment)
    COST_KEYS_UNFILLED = ("bytes accessed", "transcendentals",
                          "optimal_seconds", "utilization",
                          "temp_size_in_bytes", "output_size_in_bytes")

    def cost_analysis(self, data, label, n_steps=None):
        """The step's cost for ``(data, label)``'s signature, with the
        reference's keys where torch has a counterpart
        (``mxnet_tpu/parallel/trainer.py:980-1023``): ``flops``, the
        forward and backward's matmul and convolution flops by
        ``torch.utils.flop_counter.FlopCounterMode`` (times ``n_steps``
        for a window), and ``argument_size_in_bytes``, the bytes of the
        masters, optimizer states and batch the step takes.  ``unfilled``
        lists the reference's keys it cannot fill
        (:attr:`COST_KEYS_UNFILLED`).  The forward and backward run once
        eagerly on the current values and change nothing: the optimizer
        does not step, no auxiliary state is written, and ``mx.random``'s
        generator is put back.  A kernel launched through ``ctypes`` (K2
        and K3 in the backward, on a card) is not seen by the counter;
        K1's forward counts 4·BH·Sq·Sk·D by its custom op's formula."""
        from torch.utils.flop_counter import FlopCounterMode
        d, l = self._on_device(data), self._on_device(label)
        sig = (tuple(d.shape), str(d.dtype), tuple(l.shape), str(l.dtype))
        if n_steps is not None:
            sig = sig + (int(n_steps), False)
        cache = self.__dict__.setdefault("_cost_cache", {})
        if sig in cache:
            return cache[sig]
        if self._data_transform is not None:
            d = self._data_transform(d)
        masters = self._masters()
        live = [i for i, p in enumerate(self._plist)
                if p.grad_req != "null"]
        gen = _rng.generator(self.device)
        state = gen.get_state()
        counter = FlopCounterMode(display=False)
        try:
            with counter, torch.enable_grad():
                self._loss_and_grads(masters, live, IdCheck(), d, l)
        finally:
            gen.set_state(state)
        args = list(masters) + [t for k in self._pkeys
                                for t in self._opt_state[k]] + [d, l]
        out = {"flops": float(counter.get_total_flops()
                              * (int(n_steps) if n_steps else 1)),
               "argument_size_in_bytes": int(sum(
                   t.numel() * t.element_size() for t in args)),
               "unfilled": list(self.COST_KEYS_UNFILLED)}
        cache[sig] = out
        return out

    def opt_state_bytes_per_device(self) -> int:
        """Optimizer-state bytes on this rank's device: all of it on one
        device, ~1/dp of it under ZeRO (a step that emits a record
        refreshes the ``opt_state.bytes_per_device`` gauge with it)."""
        return sum(int(t.nbytes) for k in self._pkeys
                   for t in self._opt_state[k])

    def _account_step_telemetry(self, tok, n_steps):
        """The reference's per-step producers (``trainer.py:746-813``):
        on a mesh, the analytic collective bytes over dp (reduce-scatter
        + all-gather under ZeRO, else all-reduce) and tp, and the bytes
        the step's sequence-parallel collectives moved over sp (counted
        on its first run); every step on a mesh, else when a record is
        open, the optimizer-state gauge.  One device moves no collective
        bytes."""
        run = self._mesh_run
        if run is not None:
            tokens = getattr(self, "_last_tokens", 1)
            model = getattr(self, "_comm_model", None)
            if model is None or model[4] != tokens:
                model = self._comm_model = run.comm_model(
                    self._amp_scaler is not None, tokens) + (tokens,)
            rs, ag_, ar, tpb, _ = model
            if rs or ag_:
                telemetry.record_comm_bytes(rs * n_steps, "reduce_scatter")
                telemetry.record_comm_bytes(ag_ * n_steps, "all_gather")
            if ar:
                telemetry.record_comm_bytes(ar * n_steps, "allreduce")
            if rs or ag_ or ar:
                telemetry.record_axis_comm_bytes((rs + ag_ + ar) * n_steps,
                                                 "dp")
            if tpb:
                telemetry.record_comm_bytes(tpb * n_steps, "allreduce")
                telemetry.record_axis_comm_bytes(tpb * n_steps, "tp")
            spb = (run.step_bytes or {}).get("sp", 0)
            if spb:
                telemetry.record_comm_bytes(spb * n_steps, "ppermute")
                telemetry.record_axis_comm_bytes(spb * n_steps, "sp")
        if run is not None or tok is not None:
            telemetry.record_opt_state_bytes(
                self.opt_state_bytes_per_device())

    def run_steps(self, data, label, n_steps: int,
                  per_step_data: bool = False):
        """``n_steps`` training steps at one lr/wd, replaying the step's
        graph; returns their losses as an (n_steps,) NDArray.  With
        ``per_step_data``, data and label carry a leading ``n_steps`` axis
        and step i trains on batch i: the window goes to the device in
        one copy each, and batch i is copied device to device into the
        graph's inputs."""
        self._owner.check_ids()
        lead = 1 if per_step_data else 0
        d, l = self._stage_input(data, lead), self._stage_input(label, lead)
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
                        # a window of n steps is n replays of the graph
                        telemetry.record_dispatch()
                    fresh = False
                    losses[i] = loss
                    if b is not None:
                        bounds.append(b.clone())
                self._amp_leave()
                if bounds:
                    self._owner.defer_ids(torch.cat(bounds),
                                          entry[1].vocabs * n, self.device)
                self._stale_after_step()
                self._account_step_telemetry(tok, n)
        finally:
            telemetry.end_step(tok, "SPMDTrainer", extra={"n_steps": n})
        return NDArray._wrap(losses)

    def predict(self, data):
        """The forward in eval mode with f32 output (an NDArray over a
        copy), on CUDA replayed from one graph per input signature that
        shares the trainer's pool and stream."""
        self._owner.check_ids()
        x = self._stage_input(data)
        sig = ("predict",) + input_spec(x) + (_amp_policy.cache_token(),)
        entry, fresh = self._executable(sig, self._predict_body, (x,))
        out, bounds = self._call(sig, entry, fresh, (x,))
        out = out.clone()
        self._owner.defer_ids(bounds, entry[1].vocabs, self.device)
        return NDArray._wrap(out)

    # -- eager runs of the same functions, for comparisons -----------------------
    def _on_device(self, x):
        if isinstance(x, NDArray):
            ensure_real(x)
            x = x._data
        if isinstance(x, torch.Tensor):
            return x.to(self.device)
        return torch.as_tensor(onp.asarray(x), device=self.device)

    def _step_eager(self, data, label):
        """One step run eagerly (never captured) through the function a
        step's graph holds; an id out of range raises at once."""
        self._owner.check_ids()
        d, l = self._on_device(data), self._on_device(label)
        if self._mesh_run is not None:
            d, l = (self._mesh_run.local_batch(x) for x in (d, l))
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
        self._owner.check_ids()
        ids = IdCheck()
        out, bounds = self._predict_body(ids, self._on_device(data))
        if bounds is not None:
            IdCheck.raise_if_bad(bounds.cpu(), ids.vocabs)
        return out

    # -- persistence (``mxnet_tpu/parallel/trainer.py:1025-1317``) --------------
    _STATES_FORMAT = "mxnet_tpu-trainer-states-v1"

    def save_states(self, fname):
        """The optimizer state and step counter as an npz with a JSON
        header under ``__header__`` and one entry ``<param>::<slot>`` a
        state (bfloat16 and fp8 as their bit patterns, named in the
        header's ``dtypes``); no pickle.  On a mesh every rank calls it:
        each state is gathered whole (one at a time) and rank 0 writes
        it."""
        run = self._mesh_run
        slots = {k: len(self._opt_state[k]) for k in self._pkeys}
        dtypes = {k: [str(t.dtype).replace("torch.", "")
                      for t in self._opt_state[k]] for k in self._pkeys}
        header = {"format": self._STATES_FORMAT,
                  "num_update": self.num_update,
                  "slots": slots, "dtypes": dtypes}
        header.update(_rng_header())

        def arrays():
            for i, k in enumerate(self._pkeys):
                for j, t in enumerate(self._opt_state[k]):
                    full = t if run is None else run.full_value(i, t)
                    yield f"{k}::{j}", numpy_bits(full)[0]
            yield "__header__", onp.frombuffer(
                json.dumps(header).encode("utf-8"), dtype=onp.uint8)

        if run is not None and not run.mesh.writes():
            for _ in arrays():          # the gathers are collective
                pass
            return
        _write_npz(fname, arrays())

    def load_states(self, fname):
        """Restore :meth:`save_states` (of either package) into the
        optimizer state in place; on a mesh each rank keeps its part.
        Only that npz is read (``allow_pickle=False``: loading never runs
        code)."""
        try:
            z = onp.load(fname, allow_pickle=False)
        except (OSError, ValueError) as e:
            raise MXNetError(
                f"{fname}: not a trainer-states npz (pickled states are "
                f"refused: loading a pickle can run code): {e}") from e
        if not isinstance(z, onp.lib.npyio.NpzFile):
            raise MXNetError(f"{fname}: an .npy array, not a trainer-states "
                             f"npz")
        with z:
            if "__header__" not in z:
                raise MXNetError(
                    f"{fname}: not a trainer-states file (no __header__)")
            header = json.loads(bytes(z["__header__"]).decode("utf-8"))
            if header.get("format") != self._STATES_FORMAT:
                raise MXNetError(
                    f"{fname}: unknown trainer-states format "
                    f"{header.get('format')!r}")
            dtypes = header.get("dtypes", {})
            states = {}
            for k, n in header["slots"].items():
                if k not in self._opt_state:
                    raise MXNetError(f"unknown optimizer-state key {k!r}")
                names = dtypes.get(k) or []
                states[k] = [self._local_part(k, j, tensor_from_bits(
                    z[f"{k}::{j}"], names[j] if j < len(names) else None,
                    "cpu"), fname) for j in range(int(n))]
        self._restore_states(states, fname)
        self.num_update = int(header["num_update"])
        self.optimizer.num_update = self.num_update
        _restore_rng(header)

    def _local_part(self, k, j, full, source):
        """This rank's part of state slot ``j`` of parameter ``k`` from
        its whole value (the whole value off a mesh)."""
        run = self._mesh_run
        old = self._opt_state[k]
        if run is None or j >= len(old):
            return full
        i = self._pkeys.index(k)
        lay = run.layouts[i]
        if tuple(full.shape) != lay.shape:
            raise MXNetError(f"{source}: optimizer state {k!r} slot {j} has "
                             f"shape {tuple(full.shape)}, the trainer "
                             f"expects {lay.shape}")
        start, stop = run.box(i)
        box = full[tuple(slice(a, b) for a, b in zip(start, stop))]
        return run.from_box(i, box, old[j])

    def _restore_states(self, states, source):
        """Copy ``{key: [state tensors]}`` into the optimizer state in
        place, after checking every count, shape and dtype."""
        dst, src = [], []
        for k, new in states.items():
            old = self._opt_state[k]
            if len(new) != len(old):
                raise MXNetError(f"{source}: optimizer state {k!r} has "
                                 f"{len(new)} slots, the trainer's "
                                 f"optimizer {len(old)}")
            for i, (a, b) in enumerate(zip(old, new)):
                _check_leaf(f"optimizer state {k!r} slot {i}", b, a, source)
            dst += list(old)
            src += new
        _copy_in_place(dst, src)

    def save_checkpoint(self, directory, tag="latest", meta=None,
                        block=True):
        """Checkpoint the masters, optimizer state and step counter
        through the async checkpoint service (``checkpoint.save``): the
        step path pays only the snapshot (one device copy and one
        asynchronous copy to pinned memory); the shard files and the
        publish happen on the writer thread.  ``meta``: extra JSON for
        the manifest's header (``fit`` keeps its data cursor there).

        ``block=True`` waits for the publish and returns the checkpoint's
        path, raising ``MXNetError`` if the save failed after its
        retries; ``block=False`` returns a ``checkpoint.PendingSave`` at
        once, and a failed save logs and counts ``checkpoint.failures``
        without raising into the step."""
        from .. import checkpoint as _ckpt
        run = self._mesh_run
        tree = {}
        for i, (k, m) in enumerate(zip(self._pkeys, self._masters())):
            for name, t in [(f"param/{k}", m)] + [
                    (f"opt/{k}/{j}", st)
                    for j, st in enumerate(self._opt_state[k])]:
                part = t if run is None else run.pieces(i, t)
                if part is not None:
                    tree[name] = part
        header = {"num_update": int(self.num_update),
                  "slots": {k: len(self._opt_state[k])
                            for k in self._pkeys},
                  "meta": dict(meta or {}),
                  # the loader re-places global arrays whatever mesh
                  # wrote them
                  "mesh_axes": (dict(self.mesh.shape) if self.mesh
                                is not None else {"dp": 1})}
        header.update(_rng_header())
        if self._amp_scaler is not None:
            # the masters are f32 whatever the compute dtype; the header
            # keeps the policy and the scaler's state for the resume
            header["amp"] = {"enabled": True,
                             "compute_dtype":
                                 _amp_policy.compute_dtype_str(),
                             "scaler": self._amp_scaler.state()}
        rank, world = (self.mesh.save_rank() if self.mesh is not None
                       else _ckpt.rank_world())
        job = _ckpt.save(directory, tree, header, tag=tag, block=block,
                         rank=rank, world=world)
        return job.result() if block else job

    def load_checkpoint(self, directory, tag="latest"):
        """Restore a :meth:`save_checkpoint` (of either package; falling
        back to ``tag.old``, then to the newest ``step-<n>``), whatever
        shard layout wrote it, into the masters, optimizer state and AMP
        state in place, with the step counter.  A missing leaf, or a
        shape or dtype that differs from the trainer's, raises.  Returns
        the checkpoint's meta with ``num_update``, or None when there is
        no checkpoint."""
        from .. import checkpoint as _ckpt
        run = self._mesh_run
        masters = self._masters()
        names, boxes = {}, {}
        for i, k in enumerate(self._pkeys):
            box = (run.box(i) if run is not None else
                   ((0,) * len(masters[i].shape), tuple(masters[i].shape)))
            for name, t in [(f"param/{k}", masters[i])] + [
                    (f"opt/{k}/{j}", st)
                    for j, st in enumerate(self._opt_state[k])]:
                names[name] = (i, t)
                boxes[name] = box
        loaded = _ckpt.load_boxes(directory, tag, boxes)
        if loaded is None:
            return self._load_checkpoint_v1(directory, tag)
        leaves, header, shapes = loaded
        source = f"checkpoint {directory!r}"

        def local(name, what):
            i, t = names[name]
            if name not in shapes:
                raise MXNetError(f"checkpoint {directory!r} has no entry "
                                 f"for {what}")
            shape, dtype = shapes[name]
            want = (run.layouts[i].shape if run is not None
                    else tuple(t.shape))
            if shape != want:
                raise MXNetError(f"{source}: {what} has shape {shape}, "
                                 f"the trainer expects {want}")
            if _ckpt._torch_dtype(dtype) != t.dtype:
                raise MXNetError(f"{source}: {what} has dtype "
                                 f"torch.{dtype}, the trainer expects "
                                 f"{t.dtype}")
            box = leaves[name]
            return box if run is None else run.from_box(i, box, t)

        slots = header.get("slots") or {}
        dst, src = [], []
        for i, k in enumerate(self._pkeys):
            dst.append(masters[i])
            src.append(local(f"param/{k}", f"parameter {k!r}"))
        states = {}
        for k in self._pkeys:
            n = int(slots.get(k, len(self._opt_state[k])))
            if n != len(self._opt_state[k]):
                raise MXNetError(f"{source}: optimizer state {k!r} has {n} "
                                 f"slots, the trainer's optimizer "
                                 f"{len(self._opt_state[k])}")
            states[k] = [local(f"opt/{k}/{j}", f"optimizer state "
                                               f"{f'opt/{k}/{j}'!r}")
                         for j in range(n)]
        self._restore_states(states, source)
        _copy_in_place(dst, src)
        self._stale_after_step()
        self.num_update = int(header.get("num_update", self.num_update))
        self.optimizer.num_update = self.num_update
        _restore_rng(header)
        amp_hdr = header.get("amp")
        if amp_hdr and self._amp_scaler is not None \
                and amp_hdr.get("scaler"):
            # written into the device state before the next call
            self._amp_scaler.load_state(amp_hdr["scaler"])
        meta = dict(header.get("meta") or {})
        meta["num_update"] = self.num_update
        return meta

    def _load_checkpoint_v1(self, directory, tag):
        """The layout before the manifest: ``model.params`` and
        ``trainer.npz`` (and an optional ``meta.json``) in the tag's
        directory or its ``.old`` backup."""
        for cand in (os.path.join(directory, tag),
                     os.path.join(directory, f"{tag}.old")):
            if os.path.isfile(os.path.join(cand, "model.params")):
                break
        else:
            return None
        meta = {}
        meta_path = os.path.join(cand, "meta.json")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = dict(json.load(f))
        self.net.load_parameters(os.path.join(cand, "model.params"))
        self.load_states(os.path.join(cand, "trainer.npz"))
        meta["num_update"] = self.num_update
        return meta

    def fit(self, data_iter, epochs=1, verbose=False, checkpoint_dir=None,
            checkpoint_every=0, resume=True):
        """Epoch loop over ``data_iter`` (batches of ``(data, label)``).
        With ``checkpoint_dir``: resume from its latest checkpoint first
        (skipping the batches the checkpointed ``fit`` had seen,
        ``meta["fit_seen"]``), save asynchronously every
        ``checkpoint_every`` steps, and save blocking at the end, so that
        a returned ``fit`` has published its checkpoint.  Returns the
        losses of the steps it took, as NDArrays."""
        skip = 0
        if checkpoint_dir and resume:
            meta = self.load_checkpoint(checkpoint_dir)
            if meta:
                skip = int(meta.get("fit_seen", 0))
        losses = []
        seen = 0
        fast_forward = getattr(data_iter, "fast_forward", None)
        for epoch in range(epochs):
            batch_idx = 0
            if seen < skip and fast_forward is not None:
                try:
                    epoch_len = len(data_iter)
                except TypeError:
                    epoch_len = None
                if epoch_len is not None:
                    n = min(skip - seen, epoch_len)
                    fast_forward(n)
                    seen += n
                    batch_idx = n
            for batch in data_iter:
                seen += 1
                if seen <= skip:
                    continue            # trained before the checkpoint
                batch_idx += 1
                losses.append(self.step(batch[0], batch[1]))
                if (checkpoint_dir and checkpoint_every
                        and len(losses) % checkpoint_every == 0):
                    self.save_checkpoint(
                        checkpoint_dir, block=False,
                        meta={"fit_seen": seen,
                              "cursor": {"epoch": epoch,
                                         "batch": batch_idx}})
        if checkpoint_dir:
            # blocking, and the writer's queue is FIFO: this also drains
            # every earlier async save
            self.save_checkpoint(
                checkpoint_dir,
                meta={"fit_seen": seen,
                      "cursor": {"epoch": epochs - 1, "batch": seen}})
        return losses


def _rng_header() -> dict:
    """``mx.random``'s state for a checkpoint or states header: the
    two-word ``rng_key`` the reference reads and the exact
    ``rng_state``."""
    bits = _rng.get_state_bits()
    return {"rng_key": _rng.key_words(bits), "rng_state": bits.tolist()}


def _restore_rng(header) -> None:
    """Restore :func:`_rng_header`'s state (a reference header's
    ``rng_key`` alone seeds the generators)."""
    bits = header.get("rng_state") or header.get("rng_key")
    if bits:
        _rng.set_state_bits(bits)


def _token_count(d, lead=0) -> int:
    """Tokens of one batch for the tp volume model (the reference's
    ``_token_count``): an integer (B, T, ...) array is B·T tokens,
    anything else its batch rows."""
    shape = tuple(d.shape)[lead:]
    if not shape:
        return 1
    dt = d.dtype
    is_int = (not dt.is_floating_point if isinstance(d, torch.Tensor)
              else onp.issubdtype(dt, onp.integer))
    if is_int and len(shape) >= 2:
        return int(shape[0]) * int(shape[1])
    return int(shape[0])


def _check_leaf(what, new, old, source):
    if tuple(new.shape) != tuple(old.shape):
        raise MXNetError(f"{source}: {what} has shape {tuple(new.shape)}, "
                         f"the trainer expects {tuple(old.shape)}")
    if new.dtype != old.dtype:
        raise MXNetError(f"{source}: {what} has dtype {new.dtype}, the "
                         f"trainer expects {old.dtype}")


@torch.no_grad()
def _copy_in_place(dst, src):
    """Host or device values into the trainer's tensors, in place: what a
    captured graph holds keeps its address."""
    for d, s in zip(dst, src):
        d.copy_(s)


def _write_npz(fname, items):
    """``numpy.savez``'s file from ``(name, array)`` pairs written one at
    a time: only the array being written is held."""
    import zipfile
    with open(fname, "wb") as f, zipfile.ZipFile(
            f, "w", zipfile.ZIP_STORED, allowZip64=True) as zf:
        for name, arr in items:
            with zf.open(name + ".npy", "w", force_zip64=True) as fh:
                onp.lib.format.write_array(fh, onp.asanyarray(arr),
                                           allow_pickle=False)
