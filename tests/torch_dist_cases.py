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


def case_batchnorm_refused(axes):
    """A BatchNorm net stepped on a batch split over dp: the error."""
    import torch
    from mxnet_tpu_torch.gluon import loss as gloss
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.parallel import SPMDTrainer, make_mesh
    mesh = make_mesh(axes)
    if not mesh.is_member:
        return None
    net = nn.HybridSequential()
    net.add(nn.Dense(8, in_units=4), nn.BatchNorm(in_channels=8),
            nn.Dense(2, in_units=8))
    net.initialize(device="cpu")
    tr = SPMDTrainer(net, gloss.SoftmaxCrossEntropyLoss(), mesh=mesh)
    try:
        tr.step(torch.ones(4, 4), torch.zeros(4))
    except Exception as e:          # the message is the result
        return f"{type(e).__name__}: {e}"
    return None


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
