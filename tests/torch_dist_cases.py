"""Spawned gloo ranks for the port's multi-rank tests, and the bodies
they run.  This module imports neither ``jax`` nor ``mxnet_tpu``: the
ranks are spawned (not forked: the test process holds JAX's threads) and
import it fresh.

:class:`RankPool` starts ``world`` processes once, each joined to one
gloo group through a ``FileStore`` (under the test's tmp directory: no
port, so xdist workers run side by side), and runs each case on every
rank: ``pool.run("case_name", *args)`` returns the ranks' results in
rank order.  Every case has a deadline; a rank that misses it is killed
with the whole pool, the case fails, and the next case starts a new
pool.  A rank's exception fails the case with its traceback.

The case bodies take numpy weights and batches (the same the test feeds
the reference), build the port's side on ``device="cpu"`` and return
numpy results: losses, gathered parameters, gathered optimizer states.
"""
from __future__ import annotations

import importlib
import itertools
import multiprocessing as mp
import os
import queue
import time
import traceback

import numpy as onp

DEADLINE = 120.0          # seconds a case may take on every rank


class RankPool:
    """``world`` spawned ranks on one gloo group."""

    _ids = itertools.count()

    def __init__(self, world, tmpdir, start_timeout=120.0):
        self.world, self.tmpdir = world, str(tmpdir)
        self._start_timeout = start_timeout
        self._procs = None

    def _start(self):
        ctx = mp.get_context("spawn")
        store = os.path.join(self.tmpdir, f"store{next(self._ids)}")
        self._in = [ctx.Queue() for _ in range(self.world)]
        self._out = ctx.Queue()
        self._procs = [ctx.Process(target=_rank_main,
                                   args=(r, self.world, store, self._in[r],
                                         self._out), daemon=True)
                       for r in range(self.world)]
        for p in self._procs:
            p.start()
        self._collect("__ready__", self._start_timeout)

    def _collect(self, name, timeout):
        got, deadline = {}, time.monotonic() + timeout
        while len(got) < self.world:
            left = deadline - time.monotonic()
            try:
                rank, ok, value = self._out.get(timeout=max(left, 0.01))
            except queue.Empty:
                missing = sorted(set(range(self.world)) - set(got))
                self.close(kill=True)
                raise TimeoutError(f"{name}: ranks {missing} missed the "
                                   f"{timeout:.0f} s deadline")
            got[rank] = (ok, value)
        bad = [(r, v) for r, (ok, v) in sorted(got.items()) if not ok]
        if bad:
            self.close(kill=True)
            raise AssertionError(f"{name} failed on rank {bad[0][0]}:\n"
                                 f"{bad[0][1]}")
        return [got[r][1] for r in range(self.world)]

    def run(self, name, *args, timeout=DEADLINE):
        """Run ``name(*args)`` of this module on every rank."""
        if self._procs is None:
            self._start()
        for q in self._in:
            q.put((name, args))
        return self._collect(name, timeout)

    def close(self, kill=False):
        procs, self._procs = self._procs, None
        if not procs:
            return
        if not kill:
            for q in self._in:
                q.put(None)
            for p in procs:
                p.join(timeout=10)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)


def _rank_main(rank, world, store, inq, outq):
    os.environ["OMP_NUM_THREADS"] = "1"
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from mxnet_tpu_torch.parallel import _dist
    try:
        _dist.init("cpu", store=dist.FileStore(store, world), rank=rank,
                   world_size=world)
        outq.put((rank, True, None))
    except BaseException:
        outq.put((rank, False, traceback.format_exc()))
        return
    mod = importlib.import_module(__name__)
    while True:
        msg = inq.get()
        if msg is None:
            break
        name, args = msg
        try:
            outq.put((rank, True, getattr(mod, name)(*args)))
        except BaseException:
            outq.put((rank, False, traceback.format_exc()))
    dist.destroy_process_group()


# -- helpers on a rank ----------------------------------------------------------

def _spec(t):
    from mxnet_tpu_torch.parallel import PartitionSpec
    return None if t is None else PartitionSpec(*t)


def dense_net(weights, units=(16, 4), in_units=8, specs=None):
    """Dense(relu) → Dense on the CPU with the given weights; ``specs``
    maps a parameter name to a spec tuple."""
    import torch
    from mxnet_tpu_torch.gluon import nn
    net = nn.HybridSequential()
    net.add(nn.Dense(units[0], in_units=in_units, activation="relu"),
            nn.Dense(units[1], in_units=units[0]))
    net.initialize(device="cpu")
    for k, p in net.collect_params().items():
        p.set_data(torch.as_tensor(weights[k]))
        if specs and k in specs:
            p.shard(_spec(specs[k]))
    return net


def lm_net(weights, vocab, units, layers, heads, max_len, specs=None,
           ring_mesh=None, sp_mode="ring", use_flash=False):
    import torch
    from mxnet_tpu_torch.convert import load_collected_params
    from mxnet_tpu_torch.gluon.model_zoo.transformer import TransformerLM
    net = TransformerLM(vocab, units=units, num_layers=layers,
                        num_heads=heads, max_len=max_len,
                        use_flash=use_flash, ring_mesh=ring_mesh,
                        sp_mode=sp_mode)
    net.initialize(device="cpu")
    net(torch.zeros((1, 8), dtype=torch.int32))
    load_collected_params(net, weights, device="cpu")
    for k, p in net.collect_params().items():
        if specs and k in specs:
            p.shard(_spec(specs[k]))
    return net


def lm_loss_fn(vocab):
    from mxnet_tpu_torch.gluon import loss as gloss
    ce = gloss.SoftmaxCrossEntropyLoss()

    def lm_loss(logits, labels):
        return ce(logits.reshape(-1, vocab), labels.reshape(-1))
    return lm_loss


def _np(t):
    return t.detach().float().cpu().numpy().copy()


def train(trainer, batches):
    """Steps over ``batches``; ``(losses, gathered params, gathered
    optimizer states, opt-state bytes on this rank)``."""
    losses = [float(trainer.step(d, l).asnumpy()) for d, l in batches]
    trainer.gather_params()
    params = {k: _np(p._tensor()) for k, p in trainer._params.items()}
    states = {k: [_np(t) for t in st]
              for k, st in trainer.gather_states().items()}
    return losses, params, states, trainer.opt_state_bytes_per_device()


# -- cases ------------------------------------------------------------------------

def case_mesh_errors(world):
    """make_mesh's and MeshPlan's errors, as messages."""
    from mxnet_tpu_torch.parallel import MeshPlan, make_mesh
    out = []
    for fn in (lambda: make_mesh({"dp": 2 * world}),
               lambda: make_mesh({"dp": world, "tp": 2}),
               lambda: MeshPlan(dp=0), lambda: MeshPlan(tp=-1)):
        try:
            fn()
            out.append(None)
        except Exception as e:      # the message is the result
            out.append(str(e))
    m = make_mesh({"dp": 2, "tp": -1})
    return out, dict(m.shape), m.is_member


def case_spmd_dense(weights, specs, axes, optimizer, opt_params, batches,
                    zero_stage=0, load_after=False):
    """A Dense net through a meshed SPMDTrainer.  ``load_after``: the
    trainer is built on zero weights and the reference's full weights
    are loaded into it afterwards (``convert.load_collected_params``:
    each rank keeps its shard)."""
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.convert import load_collected_params
    from mxnet_tpu_torch.gluon import loss as gloss
    from mxnet_tpu_torch.parallel import SPMDTrainer, make_mesh
    telemetry.reset("comm.")
    mesh = make_mesh(axes)
    if not mesh.is_member:
        return None
    init = ({k: onp.zeros_like(v) for k, v in weights.items()}
            if load_after else weights)
    net = dense_net(init, specs=specs)
    tr = SPMDTrainer(net, gloss.SoftmaxCrossEntropyLoss(),
                     optimizer=optimizer, optimizer_params=opt_params,
                     mesh=mesh, zero_stage=zero_stage)
    if load_after:
        load_collected_params(net, weights, device="cpu", trainer=tr)
    out = train(tr, batches)
    comm = {k: telemetry.counter(f"comm.{k}.bytes").value
            for k in ("dp", "tp", "reduce_scatter", "all_gather",
                      "allreduce")}
    return out + (comm,)


def case_spmd_lm(weights, cfg, specs, axes, seq_axis, sp_mode, batches,
                 opt_params, zero_stage=0):
    """The transformer LM through a meshed SPMDTrainer (SGD); the bytes
    its sequence-parallel collectives moved (``comm.sp.bytes``) last."""
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.parallel import SPMDTrainer, make_mesh
    telemetry.reset("comm.")
    mesh = make_mesh(axes)
    if not mesh.is_member:
        return None
    ring = mesh if seq_axis is not None else None
    net = lm_net(weights, specs=specs, ring_mesh=ring, sp_mode=sp_mode,
                 **cfg)
    tr = SPMDTrainer(net, lm_loss_fn(cfg["vocab"]), optimizer="sgd",
                     optimizer_params=opt_params, mesh=mesh,
                     seq_axis=seq_axis, zero_stage=zero_stage)
    return train(tr, batches) + (telemetry.counter("comm.sp.bytes").value,)


def case_seq_attention(kind, q, causal, axes=None):
    """``loss = mean(attn(q, q, q)²)`` and its gradient through the
    whole-tensor wrappers (ring, ring_flash, ulysses)."""
    import torch
    from mxnet_tpu_torch import parallel as par
    mesh = par.make_mesh(axes or {"sp": -1})
    if not mesh.is_member:
        return None
    fn = {"ring": par.ring_self_attention,
          "ring_flash": par.ring_flash_self_attention,
          "ulysses": par.ulysses_self_attention}[kind]
    x = torch.tensor(q, requires_grad=True)
    loss = (fn(x, x, x, mesh, causal=causal) ** 2).mean()
    loss.backward()
    return float(loss), _np(x.grad)


def case_moe(x, params, capacity_factor, axes=None):
    """Switch MoE with the tokens and experts sharded over ep:
    ``(loss, y, gate grad, expert grads of this rank's shard, dropped,
    moe.dropped_tokens)``."""
    import torch
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.parallel import collectives as comm
    from mxnet_tpu_torch.parallel import make_mesh, switch_moe
    mesh = make_mesh(axes or {"ep": -1})
    if not mesh.is_member:
        return None
    ax = mesh.axis("ep")
    n, e = x.shape[0] // ax.size, params[0].shape[1] // ax.size
    xl = torch.tensor(x[ax.index * n:(ax.index + 1) * n])
    gate = torch.tensor(params[0], requires_grad=True)
    experts = [torch.tensor(p[ax.index * e:(ax.index + 1) * e],
                            requires_grad=True) for p in params[1:]]
    telemetry.reset("moe.")
    y, aux = switch_moe(xl, gate, *experts,
                        capacity_factor=capacity_factor, mesh=mesh)
    # the global objective: mean(y²) over all tokens + 0.01·aux, each
    # rank holding 1/ep of both terms
    loss = ((y ** 2).mean() + 0.01 * aux) / ax.size
    loss.backward()
    total = comm.all_reduce_(loss.detach().clone(), ax)
    ggate = comm.all_reduce_(gate.grad.clone(), ax)
    y_all = comm.all_gather_flat(y.detach().reshape(-1), ax)
    _, _, stats = switch_moe(xl.detach(), gate.detach(),
                             *[p.detach() for p in experts],
                             capacity_factor=capacity_factor, mesh=mesh,
                             return_stats=True)
    return (float(total), _np(y_all.reshape(x.shape[0], -1)), _np(ggate),
            [_np(p.grad) for p in experts], int(stats["dropped_tokens"]),
            telemetry.counter("moe.dropped_tokens").value)


def case_gluon_zero(weights, batches, opt_params, zero, toggle_at=None):
    """The eager Gluon loop with Trainer(zero=...) under the cached step,
    every rank on the same batches: losses, params, the states (flat
    chunks while sharded) and their bytes on this rank, the steps that
    ran as the captured function, and the cached step's last break
    reason.  ``toggle_at``: ZeRO is turned off before that step."""
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.gluon import loss as gloss
    from mxnet_tpu_torch.imperative import cached_step
    from mxnet_tpu_torch.parallel import default_mesh
    default_mesh()
    cached_step.reset_stats()
    net = dense_net(weights)
    tr = Trainer(net.collect_params(), "adam", dict(opt_params), zero=zero)
    lf = gloss.SoftmaxCrossEntropyLoss()
    losses, chunk_bytes, captured = [], None, None
    for i, (d, l) in enumerate(batches):
        if i == toggle_at:
            chunk_bytes = _state_bytes(tr._updaters[0])
            captured = cached_step.stats()["steps"]
            tr._zero = False
        x = mt.nd.array(d, ctx=mt.cpu())
        y = mt.nd.array(l, ctx=mt.cpu())
        with mt.autograd.record():
            loss = lf(net(x), y)
        loss.backward()
        tr.step(d.shape[0])
        losses.append(float(loss.mean().asnumpy()))
    updater = tr._updaters[0]
    if toggle_at is None:
        chunk_bytes = _state_bytes(updater)
        captured = cached_step.stats()["steps"]
    reason = cached_step.trainer_state(tr)["last_reason"]
    from mxnet_tpu_torch.optimizer import fused_step
    fused_step.unshard_states(updater)
    params = {k: _np(p._tensor()) for k, p in net.collect_params().items()}
    states = {k: [_np(s._data if hasattr(s, "_data") else s)
                  for s in updater.states[i]]
              for i, k in enumerate(sorted(net.collect_params().keys()))}
    return losses, params, states, chunk_bytes, captured, reason


def _state_bytes(updater):
    return sum(int(s._data.nbytes if hasattr(s, "_data") else s.nbytes)
               for st in updater.states.values() for s in st)


def case_one_rank(weights, batches, opt_params):
    """On a group of one: ``SPMDTrainer(mesh=make_mesh({"dp": -1}))`` as
    bench.py builds it, at ZeRO stages 0–3 and unmeshed; each stage's
    losses, parameters, optimizer states and state bytes."""
    from mxnet_tpu_torch.gluon import loss as gloss
    from mxnet_tpu_torch.parallel import SPMDTrainer, make_mesh
    out = {}
    for stage in (None, 0, 1, 2, 3):
        kw = {"device": "cpu"} if stage is None else {
            "mesh": make_mesh({"dp": -1}), "zero_stage": stage}
        tr = SPMDTrainer(dense_net(weights), gloss.SoftmaxCrossEntropyLoss(),
                         optimizer="adam", optimizer_params=opt_params, **kw)
        out["plain" if stage is None else stage] = train(tr, batches)
    return out


def case_shard_guards(weights, batches):
    """A Dense net with its head sharded on tp at dp2×tp2 (ZeRO-3 for the
    rest): what a parameter the trainer holds as shards allows before
    and after ``gather_params``, and ``set_full_value``.  Returns the
    outcomes in order (an error's message, or a value)."""
    import torch
    from mxnet_tpu_torch.gluon import loss as gloss
    from mxnet_tpu_torch.parallel import SPMDTrainer, make_mesh
    mesh = make_mesh({"dp": 2, "tp": 2})
    if not mesh.is_member:
        return None
    net = dense_net(weights, specs={"1.weight": ("tp", None)})
    tr = SPMDTrainer(net, gloss.SoftmaxCrossEntropyLoss(), optimizer="sgd",
                     optimizer_params={"learning_rate": 0.1}, mesh=mesh,
                     zero_stage=3)
    head = net.collect_params()["1.weight"]
    full = torch.as_tensor(weights["1.weight"])

    def attempt(fn):
        try:
            return fn()
        except Exception as e:      # the message is the result
            return f"{type(e).__name__}: {e}"

    out = []
    tr.step(*batches[0])
    out.append(attempt(lambda: head._tensor()))
    out.append(attempt(lambda: head.set_data(full)))
    tr.gather_params()
    out.append(_np(head._tensor()))
    out.append(attempt(lambda: head.set_data(full)))
    tr.set_full_value(head, full)
    out.append(attempt(lambda: head.data()))
    tr.gather_params()
    out.append(_np(head._tensor()))
    return out


# -- the pipeline schedules and Mesh4DTrainer ---------------------------------------

def relu_stage(params, x):
    """One pipeline stage (a layer): relu(x @ w + b)."""
    import torch
    w, b = params
    return torch.relu(x @ w + b)


def relu_stages(n):
    """A stage of ``n`` relu layers (params stacked on a leading axis)."""
    def stage(params, x):
        w, b = params
        for j in range(n):
            x = relu_stage((w[j], b[j]), x)
        return x
    return stage


def mse(y, t):
    return ((y.float() - t) ** 2).mean()


def _tensors(arrays, grad=False):
    import torch
    return tuple(torch.tensor(a, requires_grad=grad) for a in arrays)


def case_pipeline(kind, params, x, t, axes, M, batch_axis="dp",
                  layers_per_stage=1, fold=False):
    """One schedule on a mesh (or folded) from whole numpy values:
    ``gpipe`` / ``interleaved``: the forward's output, then the loss
    ``mse(out, t)`` and its gradients by autograd; ``1f1b``: the loss,
    the gradients and the input gradient of
    ``pipeline_value_and_grad_1f1b``.  Non-members return None."""
    import torch
    from mxnet_tpu_torch import parallel as par
    mesh = par.make_mesh(axes) if axes else None
    if mesh is not None and not mesh.is_member:
        return None
    ps = _tensors(params, grad=kind != "1f1b")
    xt, tt = torch.tensor(x), torch.tensor(t)
    stage = relu_stages(layers_per_stage) if layers_per_stage > 1 \
        else relu_stage
    kw = {"batch_axis_name": batch_axis, "fold": fold}
    if kind == "1f1b":
        loss, grads, dx = par.pipeline_value_and_grad_1f1b(
            stage, mse, ps, xt, tt, mesh, M, return_input_grad=True, **kw)
        return float(loss), [_np(g) for g in grads], _np(dx)
    if kind == "gpipe":
        out = par.pipeline_forward(stage, ps, xt, mesh, M, **kw)
    else:
        if fold:
            kw["n_stages"] = 4
        out = par.pipeline_forward_interleaved(stage, ps, xt, mesh, M, **kw)
    loss = mse(out, tt)
    grads = torch.autograd.grad(loss, ps)
    return _np(out), float(loss.detach()), [_np(g) for g in grads]


def case_pipeline_errors(params, x):
    """The validation errors of the whole-tensor entry points, as
    ``(type name, message)``."""
    import torch
    from mxnet_tpu_torch import parallel as par
    mesh = par.make_mesh({"pp": 4})
    if not mesh.is_member:
        return None
    ps = _tensors(params)
    out = []
    for fn in (lambda: par.pipeline_forward(
                   relu_stage, ps, torch.tensor(x), mesh, 2,
                   batch_axis_name=None),
               lambda: par.pipeline_forward(
                   relu_stage, tuple(p[:4] for p in ps),
                   torch.ones(10, 4), mesh, 4, batch_axis_name=None),
               lambda: par.pipeline_value_and_grad_1f1b(
                   relu_stage, mse, tuple(p[:4] for p in ps),
                   torch.ones(8, 4), torch.ones(4, 4), mesh, 2,
                   batch_axis_name=None),
               lambda: par.pipeline_forward_interleaved(
                   relu_stage, ps, torch.ones(16, 4), mesh, 8,
                   batch_axis_name=None)):
        try:
            fn()
            out.append(None)
        except Exception as e:      # the message is the result
            out.append((type(e).__name__, str(e)))
    return out


def _m4d_fns(name, plan):
    import torch
    from mxnet_tpu_torch.parallel import switch_moe

    def mlp(p, h):
        a, b = p
        return plan.tp_row(torch.relu(plan.tp_column(h @ a)) @ b)

    def mlp_bias(p, h):
        a, ab, b, c = p
        return plan.tp_row(torch.relu(plan.tp_column(h @ a + ab)) @ b) + c

    def moe(p, x):
        y, aux, stats = switch_moe(x, *p, capacity_factor=1.0,
                                   return_stats=True)
        return y, 0.01 * aux, stats["dropped_tokens"]

    def psum(p, h):
        from mxnet_tpu_torch.parallel import collectives as comm
        a, b = p
        return comm.all_reduce(torch.relu(h @ a) @ b, plan.mesh.axis("tp"))

    return {"mlp": mlp, "mlp_bias": mlp_bias, "moe": moe,
            "psum": psum}[name]


def _spec_tree(specs):
    return None if specs is None else tuple(_spec(s) for s in specs)


def case_mesh4d(plan_kw, fn, params, specs, x, y, windows, opts,
                jsonl=None):
    """``Mesh4DTrainer`` over ``MeshPlan(**plan_kw)``: the losses of each
    ``run_steps`` window in ``windows`` (step counts), then the whole
    masters and momentum, the per-axis and per-kind comm bytes, the
    dropped-token count, the state bytes on this rank and the trainer's
    compiles.  ``jsonl``: a telemetry sink's path (this rank's file has
    the rank appended)."""
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.parallel import MeshPlan, Mesh4DTrainer
    telemetry.reset("comm.")
    telemetry.reset("moe.")
    plan = MeshPlan(**plan_kw)
    if not plan.mesh.is_member:
        return None
    tr = Mesh4DTrainer(plan, _m4d_fns(fn, plan), mse, tuple(params),
                       param_specs=_spec_tree(specs), **opts)
    sink = None
    if jsonl:
        import torch.distributed as dist
        sink = telemetry.JSONLSink(f"{jsonl}.{dist.get_rank()}")
        telemetry.add_sink(sink)
    try:
        losses = [_np(tr.run_steps(x, y, n_steps=n)) for n in windows]
    finally:
        if sink is not None:
            telemetry.remove_sink(sink)
    comm_bytes = {k: telemetry.counter(f"comm.{k}.bytes").value
                  for k in ("dp", "tp", "pp", "ep", "reduce_scatter",
                            "all_gather", "allreduce", "ppermute",
                            "all_to_all")}
    return (losses, [_np(p) for p in tr.gather_params()],
            [_np(m) for m in tr.gather_momentum()], comm_bytes,
            telemetry.counter("moe.dropped_tokens").value,
            tr.state_bytes_per_device(), tr.compiles)


def case_mesh4d_dropout(params, x, y, p, seed):
    """``Mesh4DTrainer`` over dp2 × ep2 (both axes split the batch's dim
    0) with a Dropout (``mode="always"``) on the stage's input, seeded
    with ``mx.random.seed(seed)`` just before one step: this rank's
    ``(dp index, ep index, mask of its rows)``, the mask read off the
    Dropout's output (``x`` has no zeros)."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import nn as ops_nn
    from mxnet_tpu_torch.parallel import MeshPlan, Mesh4DTrainer
    plan = MeshPlan(dp=2, ep=2)
    if not plan.mesh.is_member:
        return None
    masks = []

    def mlp(ps, h):
        a, b = ps
        h = ops_nn.dropout(h, p=p, mode="always")
        masks.append(_np(h != 0))
        return torch.relu(h @ a) @ b

    tr = Mesh4DTrainer(plan, mlp, mse, tuple(params))
    mx.random.seed(seed)
    tr.run_steps(x, y, n_steps=1)
    return (plan.mesh.axis("dp").index, plan.mesh.axis("ep").index,
            masks[0])


def case_mesh4d_refusals(params):
    """Mesh4DTrainer's refusals: ep in a spec under pp, and a tp-sharded
    stage function that never calls tp_row."""
    import torch
    from mxnet_tpu_torch.parallel import MeshPlan, Mesh4DTrainer
    out = []
    plan = MeshPlan(dp=2, pp=2, ep=2)
    if plan.mesh.is_member:
        try:
            Mesh4DTrainer(plan, lambda p, h: h, mse,
                          (onp.zeros((2, 4, 4), "float32"),),
                          param_specs=(_spec(("pp", "ep", None)),))
            out.append(None)
        except Exception as e:      # the message is the result
            out.append(f"{type(e).__name__}: {e}")
    plan = MeshPlan(dp=2, tp=2)
    if plan.mesh.is_member:
        def mlp(p, h):
            a, b = p
            return torch.relu(h @ a) @ b
        tr = Mesh4DTrainer(plan, mlp, mse, tuple(params),
                           param_specs=(_spec((None, "tp")),
                                        _spec(("tp", None))))
        try:
            tr.run_steps(onp.ones((8, 16), "float32"),
                         onp.ones((8, 16), "float32"))
            out.append(None)
        except Exception as e:      # the message is the result
            out.append(f"{type(e).__name__}: {e}")
    return out or None


def case_mesh4d_restore(params, specs, x, y, directory):
    """dp2×tp2 → dp4×tp1: train 2 steps on the first plan, save, load
    into a trainer on the second and step once.  Returns (the first
    trainer's whole masters and momentum, the loaded trainer's, the
    header, the loaded trainer's loss)."""
    from mxnet_tpu_torch.parallel import MeshPlan, Mesh4DTrainer
    pa, pb = MeshPlan(dp=2, tp=2), MeshPlan(dp=4, tp=1)
    out = [None, None, None, None]
    if pa.mesh.is_member:
        ta = Mesh4DTrainer(pa, _m4d_fns("mlp", pa), mse, tuple(params),
                           param_specs=_spec_tree(specs),
                           learning_rate=0.05)
        ta.run_steps(x, y, n_steps=2)
        ta.save_checkpoint(directory)
        out[0] = ([_np(p) for p in ta.gather_params()],
                  [_np(m) for m in ta.gather_momentum()])
    import torch.distributed as dist
    dist.barrier()
    if pb.mesh.is_member:
        tb = Mesh4DTrainer(pb, _m4d_fns("mlp", pb), mse, tuple(params),
                           param_specs=_spec_tree(specs),
                           learning_rate=0.05)
        out[2] = tb.load_checkpoint(directory)
        out[1] = ([_np(p) for p in tb.gather_params()],
                  [_np(m) for m in tb.gather_momentum()])
        out[3] = _np(tb.run_steps(x, y, n_steps=1))
    return out


def case_capstone(emb, w1, w2, toks, tgt, M, lr, lr_e, mu):
    """The reference's 3-D capstone (``__graft_entry__._capstone_3d``) at
    pp2×dp2×tp2: a bf16 embedding in front of a 1F1B pipeline whose
    stages are tp-sharded (Megatron's f, then ``lax.psum``), chained
    through the input gradient into a row scatter, and SGD with momentum
    on the stacked weights.  Returns the loss and the updated
    (embedding, W1, W2, m1, m2)."""
    import torch
    from mxnet_tpu_torch.parallel import collectives as comm
    from mxnet_tpu_torch.parallel import (PartitionSpec, make_mesh,
                                          pipeline_value_and_grad_1f1b)
    mesh = make_mesh({"pp": 2, "dp": 2, "tp": 2})
    if not mesh.is_member:
        return None
    tp = mesh.axis("tp")

    def stage(p, x):
        a, b = p
        xb = comm.copy_to(x, tp)
        h = torch.relu(xb @ a.to(torch.bfloat16))
        return x + comm.all_reduce(h @ b.to(torch.bfloat16), tp)

    def loss3(y, t):
        return ((y.float() - t) ** 2).mean()

    E, W1, W2 = (torch.tensor(a) for a in (emb, w1, w2))
    ids = torch.tensor(toks).long()
    xemb = E.to(torch.bfloat16)[ids]
    specs = (PartitionSpec("pp", None, "tp"), PartitionSpec("pp", "tp", None))
    loss, (g1, g2), dxe = pipeline_value_and_grad_1f1b(
        stage, loss3, (W1, W2), xemb, torch.tensor(tgt), mesh, M,
        param_specs=specs, return_input_grad=True)
    vals = dxe.reshape(-1, E.shape[1]).float()
    new_e = E.index_add(0, ids.reshape(-1), -lr_e * vals)
    m1, m2 = g1.float(), g2.float()        # momentum from zero
    return (float(loss), _np(new_e), _np(W1 - lr * m1), _np(W2 - lr * m2),
            _np(m1), _np(m2))


def case_spmd_persist(weights, batches, directory, opt_params):
    """SPMDTrainer persistence sharded over ranks: a Dense net at dp4
    (ZeRO-3) trains 2 steps, saves a checkpoint and a states file; a
    trainer at dp2×tp2 (the head row-parallel, ZeRO-1) and one at dp4
    (ZeRO-3) load them.  Returns, per trainer, (gathered params, gathered
    states) after the load, and the losses of one more step each."""
    from mxnet_tpu_torch.gluon import loss as gloss
    from mxnet_tpu_torch.parallel import SPMDTrainer, make_mesh
    import torch.distributed as dist
    ma = make_mesh({"dp": 4})
    mb = make_mesh({"dp": 2, "tp": 2})

    def build(mesh, specs, stage, w):
        net = dense_net(w, specs=specs)
        return SPMDTrainer(net, gloss.SoftmaxCrossEntropyLoss(),
                           optimizer="adam", optimizer_params=opt_params,
                           mesh=mesh, zero_stage=stage)

    def state(tr):
        tr.gather_params()
        return ({k: _np(p._tensor()) for k, p in tr._params.items()},
                {k: [_np(t) for t in st]
                 for k, st in tr.gather_states().items()})

    zeros = {k: onp.zeros_like(v) for k, v in weights.items()}
    out = {}
    if ma.is_member:
        ta = build(ma, None, 3, weights)
        for d, l in batches[:2]:
            ta.step(d, l)
        ta.save_checkpoint(directory)
        ta.save_states(f"{directory}/states.npz")
        out["saved"] = state(ta)
        out["saved_next"] = float(ta.step(*batches[2]).asnumpy())
    dist.barrier()
    if mb.is_member:
        tb = build(mb, {"1.weight": (None, "tp")}, 1, zeros)
        tb.load_checkpoint(directory)
        out["tp"] = state(tb)
        out["tp_next"] = float(tb.step(*batches[2]).asnumpy())
    if ma.is_member:
        tc = build(ma, None, 3, zeros)
        tc.load_checkpoint(directory)
        out["dp"] = state(tc)
        td = build(ma, None, 3, weights)
        td.load_states(f"{directory}/states.npz")
        out["states"] = state(td)[1]
        out["num_update"] = td.num_update
    return out or None


# -- the distributed kvstore --------------------------------------------------

def _rsp(idx, vals, shape):
    import torch
    from mxnet_tpu_torch.ndarray.sparse import RowSparseNDArray
    return RowSparseNDArray(torch.as_tensor(vals), torch.as_tensor(idx),
                            shape)


def _count_calls(name):
    """Wrap ``torch.distributed.<name>`` to count its calls; returns
    (counter list, undo)."""
    import torch.distributed as dist
    calls, orig = [], getattr(dist, name)

    def counted(*a, **k):
        calls.append(name)
        return orig(*a, **k)
    setattr(dist, name, counted)
    return calls, lambda: setattr(dist, name, orig)


def case_kv_pushpull(values, bcast):
    """``dist_sync`` without an optimizer: one pushpull of every key of
    this rank's values (keys over float32 and float64: one all-reduce a
    dtype), a broadcast of rank 0's array, a barrier, and the store's
    identity as the checkpoint layer and the store report it."""
    import torch.distributed as dist
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import checkpoint
    rank = dist.get_rank()
    kv = mt.kv.create("dist_sync")
    mine = values[rank]
    keys = sorted(mine)
    with mt.cpu():
        grads = [mt.nd.array(mine[k], dtype=mine[k].dtype) for k in keys]
        outs = [mt.nd.zeros(mine[k].shape, dtype=mine[k].dtype)
                for k in keys]
        for k, g in zip(keys, grads):
            kv.init(k, g)
        calls, undo = _count_calls("all_reduce")
        try:
            kv.pushpull(keys, grads, out=outs)
        finally:
            undo()
        b_out = mt.nd.zeros(bcast[rank].shape)
        kv.broadcast("b", mt.nd.array(bcast[rank]), out=b_out)
    kv.barrier()
    return {"out": {k: o.asnumpy() for k, o in zip(keys, outs)},
            "allreduce_calls": len(calls), "bcast": b_out.asnumpy(),
            "rank_world": (kv.rank, kv.num_workers),
            "ckpt_rank_world": checkpoint.rank_world(),
            "dead": kv.get_num_dead_node(), "type": kv.type}


def case_kv_zero(w0, grads, opt, opt_params):
    """``update_on_kvstore``: the store's optimizer on this rank's ZeRO
    slice of every key, three pushes of this rank's gradients; the
    weights after each push, the slice bounds and the slice states."""
    import torch.distributed as dist
    import mxnet_tpu_torch as mt
    rank = dist.get_rank()
    kv = mt.kv.create("dist_sync")
    kv.set_optimizer(mt.optimizer.create(opt, **opt_params))
    keys = sorted(w0)
    with mt.cpu():
        for k in keys:
            kv.init(k, mt.nd.array(w0[k]))
        seen = []
        for step in grads[rank]:
            outs = [mt.nd.zeros(w0[k].shape) for k in keys]
            kv.pushpull(keys, [mt.nd.array(step[k]) for k in keys],
                        out=outs)
            seen.append({k: o.asnumpy() for k, o in zip(keys, outs)})
    bounds = {k: kv._slice_bounds(w0[k].size) for k in keys}
    states = {k: [s.asnumpy() for s in kv._opt_states[k]] for k in keys}
    return seen, bounds, states


def case_kv_compressed(grads, threshold):
    """2-bit compression on ``dist_sync`` with no optimizer: each push's
    reduced gradients, the residuals, and the packed bytes against the
    dense ones."""
    import torch.distributed as dist
    import mxnet_tpu_torch as mt
    rank = dist.get_rank()
    kv = mt.kv.create("dist_sync")
    kv.set_gradient_compression({"type": "2bit", "threshold": threshold})
    keys = sorted(grads[rank][0])
    out = []
    with mt.cpu():
        for k in keys:
            kv.init(k, mt.nd.zeros(grads[rank][0][k].shape))
        for step in grads[rank]:
            outs = [mt.nd.zeros(step[k].shape) for k in keys]
            kv.pushpull(keys, [mt.nd.array(step[k]) for k in keys],
                        out=outs)
            out.append({k: o.asnumpy() for k, o in zip(keys, outs)})
    res = {k: _np(v) for k, v in kv._compression._residuals.items()}
    return out, res, dict(kv.last_compressed)


def case_kv_rowsparse(pushes, shape, opt_params):
    """Row-sparse pushes on ``dist_sync``: the pure reduce (the stored
    value stays row-sparse), its payload bytes, and then the store's
    optimizer (lazy SGD) on a weight."""
    import torch.distributed as dist
    import mxnet_tpu_torch as mt
    rank = dist.get_rank()
    mine = pushes[rank]
    kv = mt.kv.create("dist_sync")
    with mt.cpu():
        kv.pushpull(["a", "b"], [_rsp(*mine["a"], shape),
                                 _rsp(*mine["b"], shape)])
        a, b = kv._data["a"], kv._data["b"]
        reduced = {n: (_np(v.indices), _np(v.data)) for n, v in
                   (("a", a), ("b", b))}
        comm = dict(kv.last_sparse_comm)
        upd = mt.kv.create("dist_sync")
        upd.set_optimizer(mt.optimizer.SGD(**opt_params))
        upd.init("w", mt.nd.zeros(shape))
        upd.push("w", _rsp(*mine["a"], shape))
        upd.push("w", [_rsp(*mine["b"], shape), _rsp(*mine["a"], shape)])
        w = mt.nd.zeros(shape)
        upd.pull("w", out=w)
        rows = upd.row_sparse_pull("w", row_ids=mine["a"][0])
    return reduced, comm, w.asnumpy(), (_np(rows.indices), _np(rows.data))


def case_kv_async(w0, grads, lr, bound):
    """``dist_async`` (stale-synchronous) with SGD: after each push the
    replica this rank reads; then ``reconcile``."""
    import os
    import torch.distributed as dist
    import mxnet_tpu_torch as mt
    os.environ["MXNET_ASYNC_STALENESS_BOUND"] = str(bound)
    try:
        kv = mt.kv.create("dist_async")
    finally:
        del os.environ["MXNET_ASYNC_STALENESS_BOUND"]
    rank = dist.get_rank()
    kv.set_optimizer(mt.optimizer.SGD(learning_rate=lr))
    views = []
    with mt.cpu():
        kv.init("w", mt.nd.array(w0))
        for g in grads[rank]:
            kv.push("w", mt.nd.array(g))
            out = mt.nd.zeros(w0.shape)
            kv.pull("w", out=out)
            views.append(out.asnumpy())
        kv.reconcile()
        out = mt.nd.zeros(w0.shape)
        kv.pull("w", out=out)
    return views, out.asnumpy(), kv._slice_bounds(w0.size)


def case_kv_states_files(w0, grads, directory, ref_file):
    """ZeRO optimizer states (Adam) through files: this rank saves its
    slices' states; then loads the file the reference wrote."""
    import os
    import torch.distributed as dist
    import mxnet_tpu_torch as mt
    rank = dist.get_rank()
    kv = mt.kv.create("dist_sync")
    kv.set_optimizer(mt.optimizer.Adam(learning_rate=0.01))
    with mt.cpu():
        kv.init("0", mt.nd.array(w0))
        for g in grads[rank]:
            kv.push("0", mt.nd.array(g))
    path = os.path.join(directory, f"states{rank}")
    kv.save_optimizer_states(path)
    saved = [s.asnumpy() for s in kv._opt_states["0"]]
    kv.load_optimizer_states(ref_file)
    loaded = {k: [s.asnumpy() for s in v]
              for k, v in kv._opt_states.items()}
    return path, saved, loaded


def case_kv_trainer_lm(weights, cfg, batches, opt_params, kvstore="dist_sync",
                       uok=None):
    """The eager Gluon loop on a small TransformerLM with
    ``gluon.Trainer(kvstore=...)``, each rank its half of every batch and
    ``step(whole batch)``: losses of the halves, the parameters, whether
    the store updated them, and why the cached step declined."""
    import torch.distributed as dist
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import convert
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.gluon import loss as gloss
    from mxnet_tpu_torch.imperative import cached_step
    rank, world = dist.get_rank(), dist.get_world_size()
    net = lm_net(weights, cfg["vocab"], cfg["units"], cfg["layers"],
                 cfg["heads"], cfg["max_len"])
    tr = Trainer(net.collect_params(), "sgd", dict(opt_params),
                 kvstore=kvstore, update_on_kvstore=uok)
    lf = gloss.SoftmaxCrossEntropyLoss()
    losses = []
    for d, l in batches:
        n = d.shape[0] // world
        x = mt.nd.array(d[rank * n:(rank + 1) * n], ctx=mt.cpu(),
                        dtype="int32")
        y = mt.nd.array(l[rank * n:(rank + 1) * n], ctx=mt.cpu(),
                        dtype="int32")
        with mt.autograd.record():
            loss = lf(net(x), y)
        loss.backward()
        tr.step(d.shape[0])
        losses.append(loss.asnumpy())
    return (losses, convert.collected_params_to_numpy(net),
            tr._update_on_kvstore, cached_step.trainer_state(tr)[
                "last_reason"])


def case_kv_p3(weights, x, threshold, kvstore="p3store_dist"):
    """``p3store_dist`` (or ``kvstore`` with ``update_on_kvstore=False``)
    under ``gluon.Trainer`` on a 6-layer Dense net: the order of the
    backward's layer gradients ("bwd") and the pushes ("push") of a
    steady step, the all-reduces it makes, the parameters after three
    steps, and the refusal of ``update_on_kvstore``."""
    import os
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import autograd as ag
    from mxnet_tpu_torch.gluon import Trainer, nn
    from mxnet_tpu_torch.kvstore.p3store import P3StoreDist
    os.environ["MXNET_KVSTORE_SLICE_THRESHOLD"] = str(threshold)
    try:
        net = nn.HybridSequential()
        for _ in range(6):
            net.add(nn.Dense(16, in_units=16, activation="relu"))
        net.add(nn.Dense(2, in_units=16))
        net.initialize(device="cpu")
        for k, p in net.collect_params().items():
            p.set_data(torch.as_tensor(weights[k]))
        tr = Trainer(net.collect_params(), "sgd", {"learning_rate": 0.01},
                     kvstore=kvstore, update_on_kvstore=False)
        events = []
        orig_pp = P3StoreDist.pushpull

        def spy_pp(self, *a, **kw):
            events.append("push")
            return orig_pp(self, *a, **kw)

        def mark(block, inputs, output):
            output._data.register_hook(lambda g: events.append("bwd"))
        for blk in net._children.values():
            blk.register_forward_hook(mark)
        xs = mt.nd.array(x, ctx=mt.cpu())
        P3StoreDist.pushpull = spy_pp
        calls, undo = _count_calls("all_reduce")
        try:
            for i in range(3):
                if i == 2:
                    events.clear()
                    calls.clear()
                with mt.autograd.record():
                    out = net(xs).sum()
                out.backward()
                tr.step(1)
        finally:
            P3StoreDist.pushpull = orig_pp
            undo()
            ag.set_grad_ready_hook(None)
        params = {k: _np(p._tensor()) for k, p in
                  net.collect_params().items()}
        try:
            Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1},
                    kvstore="p3store_dist", update_on_kvstore=True
                    )._init_kvstore()
            refused = None
        except Exception as e:
            refused = str(e)
    finally:
        del os.environ["MXNET_KVSTORE_SLICE_THRESHOLD"]
    return events, len(calls), params, refused


def case_kv_horovod(x):
    """``horovod`` over ``MXNET_HOROVOD_BACKEND=torch``: pushpull sums,
    broadcast ships rank 0's value, rank and size."""
    import os
    import torch.distributed as dist
    import mxnet_tpu_torch as mt
    os.environ["MXNET_HOROVOD_BACKEND"] = "torch"
    try:
        kv = mt.kv.create("horovod")
    finally:
        del os.environ["MXNET_HOROVOD_BACKEND"]
    rank = dist.get_rank()
    with mt.cpu():
        v = mt.nd.array(x[rank])
        kv.pushpull("g", v)
        out = mt.nd.zeros(x[rank].shape)
        kv.broadcast("b", mt.nd.array(x[rank]), out=out)
    return v.asnumpy(), out.asnumpy(), (kv.rank, kv.num_workers,
                                        kv.local_rank)


def case_uncoordinated_async(addr, w0, grads, rsp):
    """``dist_async`` with ``MXNET_ASYNC_UNCOORDINATED=1``: every push to
    rank 0's parameter server at ``addr``, applied on arrival (unequal
    counts), then each rank's read; rank 1 then closes its connection
    and rank 0 counts a dead worker."""
    import os
    import time
    import torch.distributed as dist
    import mxnet_tpu_torch as mt
    os.environ["MXNET_ASYNC_UNCOORDINATED"] = "1"
    os.environ["MXNET_PS_ADDR"] = addr
    try:
        rank = dist.get_rank()
        with mt.cpu():
            kv = mt.kv.create("dist_async")
            kv.set_optimizer(mt.optimizer.SGD(learning_rate=0.1))
            kv.init("0", mt.nd.array(w0))
            kv.init("s", mt.nd.zeros((6, 3)))
            dist.barrier()
            res = {"dead_before": kv.get_num_dead_node()}
            for g in grads[rank]:
                kv.push("0", mt.nd.array(g))
            kv.push("s", _rsp(rsp[0], rsp[1], (6, 3)))
            dist.barrier()
            out = mt.nd.zeros(w0.shape)
            kv.pull("0", out=out)
            s = mt.nd.zeros((6, 3))
            kv.pull("s", out=s)
            rows = kv.row_sparse_pull("s", row_ids=onp.array([4]))
            res.update(weight=out.asnumpy(), sparse=s.asnumpy(),
                       rows=_np(rows.data))
            if rank == 0:
                res["counts"] = kv._ps_client.push_count("0")
            dist.barrier()
            if rank == 1:
                kv._ps_client.close()
            dist.barrier()
            if rank == 0:
                for _ in range(100):
                    if kv.get_num_dead_node() == 1:
                        break
                    time.sleep(0.05)
                res["dead_after"] = kv.get_num_dead_node()
        return res
    finally:
        del os.environ["MXNET_ASYNC_UNCOORDINATED"]
        del os.environ["MXNET_PS_ADDR"]


def launch_worker(outdir):
    """A worker started by ``tools/launch.py``: joins the group from the
    launcher's variables (gloo), pushes its rank + 1 through
    ``dist_sync`` and writes what it read."""
    import json
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.kvstore.dist import init_distributed
    init_distributed(device="cpu")
    kv = mt.kv.create("dist_sync")
    with mt.cpu():
        g = mt.nd.array(onp.full((3,), kv.rank + 1.0, "float32"))
        kv.init("g", g)
        out = mt.nd.zeros((3,))
        kv.pushpull("g", g, out=out)
    with open(os.path.join(outdir, f"rank{kv.rank}.json"), "w") as f:
        json.dump({"rank": kv.rank, "world": kv.num_workers,
                   "out": out.asnumpy().tolist()}, f)


if __name__ == "__main__":
    import sys
    if sys.argv[1:2] == ["launch_worker"]:
        launch_worker(sys.argv[2])


# -- cross-rank BatchNorm ---------------------------------------------------------

def layer_net(nn, layers):
    """A HybridSequential of ``layers``, ``(class name, args, kwargs)``
    tuples: the same net in either package's ``gluon.nn``."""
    net = nn.HybridSequential()
    for name, args, kw in layers:
        net.add(getattr(nn, name)(*args, **kw))
    return net


def _bits(t):
    """A tensor's bytes, for bitwise comparisons across ranks."""
    return t.detach().cpu().contiguous().numpy().tobytes()


def case_bn_train(layers, weights, axes, batches, opt, mode, trainer_kw):
    """A net with BatchNorm through a meshed SPMDTrainer (SGD) on the
    whole batches, each rank training on its dp shard: ``(losses,
    gathered parameters, the running statistics' bits)``; ``mode``
    ``"run_steps"`` runs the batches' count of steps on the first batch
    in one window.  ``axes`` None: the unmeshed trainer."""
    import torch
    from mxnet_tpu_torch.gluon import loss as gloss
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.parallel import SPMDTrainer, make_mesh
    mesh = make_mesh(axes) if axes is not None else None
    if mesh is not None and not mesh.is_member:
        return None
    net = layer_net(nn, layers)
    net.initialize(device="cpu")
    for k, p in net.collect_params().items():
        p.set_data(torch.as_tensor(weights[k]))
    kw = {"mesh": mesh} if mesh is not None else {"device": "cpu"}
    tr = SPMDTrainer(net, gloss.SoftmaxCrossEntropyLoss(), optimizer="sgd",
                     optimizer_params=opt, **kw, **trainer_kw)
    if mode == "step":
        losses = [float(tr.step(d, l).asnumpy()) for d, l in batches]
    else:
        losses = [float(v) for v in tr.run_steps(
            batches[0][0], batches[0][1], len(batches)).asnumpy()]
    tr.gather_params()
    params = {k: _np(p._tensor()) for k, p in tr._params.items()}
    stats = {k: _bits(p._tensor()) for k, p in tr._params.items()
             if k.endswith(("running_mean", "running_var"))}
    return losses, params, stats


def case_bn_reducer(x_shards, gamma, beta, dy_shards, axes):
    """``sync_batch_norm`` on this rank's shard with the reducer over
    ``axes``: ``(out, mean, var, dx, dgamma, dbeta)`` of the shard (dγ
    and dβ this rank's sums)."""
    import torch
    from mxnet_tpu_torch.ops.nn import sync_batch_norm
    from mxnet_tpu_torch.parallel import collectives as comm
    from mxnet_tpu_torch.parallel import make_mesh
    mesh = make_mesh(axes)
    if not mesh.is_member:
        return None
    i = mesh.coordinate("dp")
    x = torch.tensor(x_shards[i], requires_grad=True)
    g = torch.tensor(gamma, requires_grad=True)
    b = torch.tensor(beta, requires_grad=True)
    out, mean, var = sync_batch_norm(
        x, g, b, comm.BatchReducer([mesh.axis("dp")]), eps=1e-5,
        fix_gamma=False)
    dx, dg, db = torch.autograd.grad(out, [x, g, b],
                                     torch.tensor(dy_shards[i]))
    return tuple(_np(t) for t in (out, mean, var, dx, dg, db))


# -- parameter specs over every axis, Megatron's pairing ----------------------------

def expert_net(weights, experts, hidden, units, classes, specs=None):
    """An expert-stacked weight (E, H, F) read whole by one matmul, then a
    Dense head, with the given weights and specs."""
    import torch
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.gluon.block import HybridBlock
    from mxnet_tpu_torch.gluon.parameter import Parameter

    class Experts(HybridBlock):
        def __init__(self):
            super().__init__()
            self.w = Parameter("w", shape=(experts, hidden, units))

        def forward(self, x):
            return torch.relu(x @ self.w._tensor().reshape(
                experts * hidden, units))

    net = nn.HybridSequential()
    net.add(Experts(), nn.Dense(classes, in_units=units))
    net.initialize(device="cpu")
    for k, p in net.collect_params().items():
        p.set_data(torch.as_tensor(weights[k]))
        if specs and k in specs:
            p.shard(_spec(specs[k]))
    return net


def case_spec_train(kind, weights, specs, axes, opt, batches, zero_stage):
    """A Dense net (``kind`` "dense") or the expert net ("experts") with
    parameter specs over any mesh axis through a meshed SPMDTrainer
    (Adam): ``(losses, gathered params, gathered states, opt-state bytes
    on this rank, {key: this rank's master shape})``."""
    from mxnet_tpu_torch.gluon import loss as gloss
    from mxnet_tpu_torch.parallel import SPMDTrainer, make_mesh
    mesh = make_mesh(axes)
    if not mesh.is_member:
        return None
    net = (dense_net(weights, specs=specs) if kind == "dense" else
           expert_net(weights, specs=specs, **EXPERT_DIMS))
    tr = SPMDTrainer(net, gloss.SoftmaxCrossEntropyLoss(), optimizer="adam",
                     optimizer_params=opt, mesh=mesh, zero_stage=zero_stage)
    shapes = {k: tuple(m.shape) for k, m in zip(tr._pkeys, tr._masters())}
    return train(tr, batches) + (shapes,)


EXPERT_DIMS = dict(experts=4, hidden=2, units=6, classes=4)


def case_spec_resave(weights, batches, opt, root):
    """A trainer with P("dp", None) at dp4 takes two steps and saves; a
    trainer at dp2 x tp2 with the weights spec'd P(("dp", "tp"), None) and
    P(None, "tp") under ZeRO 1 restores it.  Both gathered: ``(saved
    params, saved states, restored params, restored states)``."""
    from mxnet_tpu_torch.gluon import loss as gloss
    from mxnet_tpu_torch.parallel import SPMDTrainer, make_mesh
    zeros = {k: onp.zeros_like(v) for k, v in weights.items()}
    a = SPMDTrainer(dense_net(weights, specs={"0.weight": ("dp", None)}),
                    gloss.SoftmaxCrossEntropyLoss(), optimizer="adam",
                    optimizer_params=opt, mesh=make_mesh({"dp": 4}))
    for d, l in batches:
        a.step(d, l)
    a.save_checkpoint(root)
    b = SPMDTrainer(dense_net(zeros, specs={"0.weight": (("dp", "tp"), None),
                                            "1.weight": (None, "tp")}),
                    gloss.SoftmaxCrossEntropyLoss(), optimizer="adam",
                    optimizer_params=opt,
                    mesh=make_mesh({"dp": 2, "tp": 2}), zero_stage=1)
    b.load_checkpoint(root)
    out = []
    for tr in (a, b):
        tr.gather_params()
        out.append({k: _np(p._tensor()) for k, p in tr._params.items()})
        out.append({k: [_np(t) for t in st]
                    for k, st in tr.gather_states().items()})
    return tuple(out)


def case_pairing(weights, specs, axes, batches, opt, nested):
    """A column- then a row-parallel Dense at dp x tp, adjacent in one
    HybridSequential (Megatron's pair) or, ``nested``, the row layer
    inside a child Sequential (not paired): ``(losses, gathered params,
    gathered states, the first step's bytes over tp by
    collectives.tally)``."""
    import torch
    from mxnet_tpu_torch.gluon import loss as gloss
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.parallel import SPMDTrainer, make_mesh
    mesh = make_mesh(axes)
    if not mesh.is_member:
        return None
    net = nn.HybridSequential()
    col = nn.Dense(16, in_units=8, activation="relu")
    row = nn.Dense(4, in_units=16)
    if nested:
        net.add(col, nn.HybridSequential().add(row))
    else:
        net.add(col, row)
    net.initialize(device="cpu")
    for name, blk in (("0", col), ("1", row)):
        for attr in ("weight", "bias"):
            p = getattr(blk, attr)
            p.set_data(torch.as_tensor(weights[f"{name}.{attr}"]))
            if f"{name}.{attr}" in specs:
                p.shard(_spec(specs[f"{name}.{attr}"]))
    tr = SPMDTrainer(net, gloss.SoftmaxCrossEntropyLoss(), optimizer="sgd",
                     optimizer_params=opt, mesh=mesh)
    losses = [float(tr.step(d, l).asnumpy()) for d, l in batches]
    tp_bytes = (tr._mesh_run.step_bytes or {}).get("tp", 0)
    tr.gather_params()
    params = {k: _np(p._tensor()) for k, p in zip(("0.weight", "0.bias",
                                                    "1.weight", "1.bias"),
                                                   (col.weight, col.bias,
                                                    row.weight, row.bias))}
    return losses, params, tp_bytes


def case_dropout_train(layers, weights, axes, batches, opt, seed):
    """A net with Dropout through SPMDTrainer (SGD), ``mx.random`` seeded
    with ``seed`` just before the steps, each rank on its dp shard of the
    whole batches: ``(losses, gathered parameters)``.  ``axes`` None: the
    unmeshed trainer."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon import loss as gloss
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.parallel import SPMDTrainer, make_mesh
    mesh = make_mesh(axes) if axes is not None else None
    if mesh is not None and not mesh.is_member:
        return None
    net = layer_net(nn, layers)
    net.initialize(device="cpu")
    for k, p in net.collect_params().items():
        p.set_data(torch.as_tensor(weights[k]))
    kw = {"mesh": mesh} if mesh is not None else {"device": "cpu"}
    tr = SPMDTrainer(net, gloss.SoftmaxCrossEntropyLoss(), optimizer="sgd",
                     optimizer_params=opt, **kw)
    mx.random.seed(seed)
    losses = [float(tr.step(d, l).asnumpy()) for d, l in batches]
    tr.gather_params()
    return losses, {k: _np(p._tensor()) for k, p in tr._params.items()}
