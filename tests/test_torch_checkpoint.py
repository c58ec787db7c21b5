"""The port's checkpoint service (``checkpoint.py``, ``checkpoint_gc.py``,
``faultinject.py``) and the trainers' persistence, on the CPU.

* The cases of the reference's ``tests/test_checkpoint_resume.py`` and
  ``tests/test_elastic.py`` that need no multi-device mesh, on the port:
  the round trip, ``fit``'s resume, the crash-durable publish, the v2
  layout, corruption, the async degradation, the two-rank commit barrier
  with threads as ranks, the single-failure invariant over the
  ``MXNET_FAULT_SPEC`` sites, keep-last-N GC and the verifier.  The
  barrier tests bound every wait by ``MXNET_CKPT_BARRIER_TIMEOUT_S`` and
  a ``result(timeout)``, and the verifier test by its own deadline.
* Resume: an ``SPMDTrainer`` (Adam; SGD momentum on a BatchNorm net) and
  a ``gluon.Trainer`` run k steps, save, load into fresh objects and run
  k more, bitwise equal to an uninterrupted run.
* Across packages: a checkpoint the reference's ``SPMDTrainer`` writes on
  the 8-device virtual CPU mesh resumes in the port, whose next steps
  follow the reference's at ``tests/test_torch_transformer_train.py``'s
  fp32 tolerance (losses rtol 1e-4; weights within 1e-5 but for a share
  under 1e-3 of them, none past the Adam sign-flip bound); a checkpoint
  the port writes loads into the reference exactly and steps there.
"""
import json
import os
import pickle
import shutil
import threading
import time

import jax
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.gluon import loss as jax_loss
from mxnet_tpu.gluon.model_zoo.transformer import TransformerLM as JaxLM
from mxnet_tpu.ndarray import NDArray as JaxNDArray
from mxnet_tpu.parallel import SPMDTrainer as JaxTrainer
from mxnet_tpu.parallel import make_mesh

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import (checkpoint, checkpoint_gc, convert, faultinject,
                             initializer, telemetry)
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import loss as gloss
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.gluon.model_zoo import TransformerLM
from mxnet_tpu_torch.parallel import SPMDTrainer


@pytest.fixture(autouse=True)
def _reset_fault_state():
    yield
    faultinject.clear()
    checkpoint_gc.stop()
    checkpoint.wait_pending(timeout=60)


def _trainer(seed=0, opt="adam", bn=False):
    net = nn.HybridSequential()
    net.add(nn.Dense(32, activation="relu"))
    if bn:
        net.add(nn.BatchNorm())
    net.add(nn.Dense(4))
    net.initialize(init=initializer.Xavier(), ctx=mt.cpu(),
                   generator=torch.Generator().manual_seed(seed))
    net(torch.zeros((2, 8)))
    params = {"learning_rate": 1e-2}
    if opt == "sgd":
        params.update(momentum=0.9, wd=1e-4)
    return SPMDTrainer(net, gloss.SoftmaxCrossEntropyLoss(), optimizer=opt,
                       optimizer_params=params, device="cpu")


def _batches(n=8, bs=16, seed=1):
    rng = onp.random.RandomState(seed)
    return [(torch.from_numpy(rng.randn(bs, 8).astype("float32")),
             torch.from_numpy(rng.randint(0, 4, (bs,)).astype("float32")))
            for _ in range(n)]


def _state(tr):
    out = {f"param/{k}": tr._params[k]._tensor().detach().clone()
           for k in tr._pkeys}
    for k in tr._pkeys:
        for i, t in enumerate(tr._opt_state[k]):
            out[f"opt/{k}/{i}"] = t.clone()
    return out


def _assert_bitwise(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


# -- the reference's test_checkpoint_resume.py cases ------------------------------

def test_checkpoint_roundtrip_and_counter(tmp_path):
    tr = _trainer()
    for d, l in _batches(3):
        tr.step(d, l)
    saves = telemetry.counter("checkpoint.saves").value
    path = tr.save_checkpoint(tmp_path)
    assert os.path.isdir(path)
    assert telemetry.counter("checkpoint.saves").value == saves + 1
    assert telemetry.histogram("checkpoint.snapshot_ms").count >= 1
    assert telemetry.histogram("checkpoint.save_ms").count >= 1

    tr2 = _trainer(seed=99)          # other weights on purpose
    ptrs = tr2._state_ptrs()
    meta = tr2.load_checkpoint(tmp_path)
    assert meta and meta["num_update"] == 3
    assert tr2.num_update == tr2.optimizer.num_update == 3
    _assert_bitwise(_state(tr2), _state(tr))
    assert tr2._state_ptrs() == ptrs          # written in place
    assert _trainer().load_checkpoint(os.path.join(tmp_path, "no")) is None


def test_fit_resume_matches_uninterrupted(tmp_path):
    """Bitwise: a fit stopped after 4 batches (checkpoints every 2) and a
    fresh trainer that resumes from its checkpoint end where 8 steps
    straight through end."""
    data = _batches(8)
    ref = _trainer()
    ref_losses = ref.fit(data)
    half = _trainer()
    half.fit(data[:4], checkpoint_dir=tmp_path, checkpoint_every=2)
    resumed = _trainer(seed=123)
    losses = resumed.fit(data, checkpoint_dir=tmp_path, checkpoint_every=2)
    assert resumed.num_update == 8 and len(losses) == 4
    assert [float(x) for x in losses] == [float(x) for x in ref_losses[4:]]
    _assert_bitwise(_state(resumed), _state(ref))
    assert len(ref_losses) == 8


def test_publish_is_crash_durable(tmp_path):
    """The old checkpoint is renamed aside (``.old``) before the new one
    lands, and ``load_checkpoint`` falls back to that backup."""
    tr = _trainer()
    d, l = _batches(1)[0]
    tr.step(d, l)
    tr.save_checkpoint(tmp_path)
    os.replace(tmp_path / "latest", tmp_path / "latest.old")
    tr2 = _trainer(seed=42)
    meta = tr2.load_checkpoint(tmp_path)
    assert meta is not None and tr2.num_update == 1
    _assert_bitwise(_state(tr2), _state(tr))


def test_fit_skip_counts_only_fit_batches(tmp_path):
    """Steps outside ``fit`` do not make a resume skip untrained batches:
    the skip is the checkpoint's ``fit_seen``."""
    data = _batches(4)
    tr = _trainer()
    d, l = _batches(1, bs=8)[0]
    tr.step(d, l)
    tr.step(d, l)
    tr.fit(data[:2], checkpoint_dir=tmp_path, checkpoint_every=1)
    assert tr.num_update == 4
    tr2 = _trainer(seed=9)
    tr2.fit(data, checkpoint_dir=tmp_path)
    assert tr2.num_update == 6


def test_publish_survives_backup_only_state(tmp_path):
    """A publish from the only-``.old`` state never deletes the surviving
    checkpoint before the new one lands."""
    tr = _trainer()
    d, l = _batches(1)[0]
    tr.step(d, l)
    tr.save_checkpoint(tmp_path)
    os.replace(tmp_path / "latest", tmp_path / "latest.old")
    tr.step(d, l)
    tr.save_checkpoint(tmp_path)
    meta = _trainer(seed=3).load_checkpoint(tmp_path)
    assert meta and meta["num_update"] == 2
    assert not (tmp_path / "latest.old").exists()


def test_v2_layout_manifest_and_shards(tmp_path):
    """Per-device shard npz files plus a manifest with the format tag,
    the header (step, meta, slots, mesh axes) and, per leaf, the global
    shape and each shard's slice."""
    tr = _trainer()
    d, l = _batches(1)[0]
    tr.step(d, l)
    path = tr.save_checkpoint(tmp_path, meta={"note": "hi"})
    names = sorted(os.listdir(path))
    assert names == ["manifest.json", "shard-d0.npz"]
    with open(os.path.join(path, "manifest.json")) as f:
        doc = json.load(f)
    assert doc["format"] == "mxnet_tpu-checkpoint-v2" and doc["world"] == 1
    hdr = doc["header"]
    assert hdr["num_update"] == 1 and hdr["meta"]["note"] == "hi"
    assert hdr["mesh_axes"] == {"dp": 1}
    assert hdr["slots"] == {k: 2 for k in tr._pkeys}
    for k in tr._pkeys:
        leaf = doc["leaves"][f"param/{k}"]
        assert tuple(leaf["shape"]) == tuple(tr._params[k].shape)
        assert leaf["dtype"] == "float32"
        for sh in leaf["shards"]:
            assert sh["file"] == "shard-d0.npz"
            assert sh["start"] == [0] * len(leaf["shape"])
            assert sh["stop"] == leaf["shape"]
    assert set(doc["files"]) == {"shard-d0.npz"}


def test_prng_chain_is_carried_not_drawn(tmp_path):
    """A reference behaviour the port does not copy: the reference saves
    and restores its global PRNG chain (``rng_key``).  The port has no
    ``mx.random`` yet and draws nothing, so it writes no chain of its
    own, and writes a loaded one through unchanged."""
    tr = _trainer()
    d, l = _batches(1)[0]
    tr.step(d, l)
    path = tr.save_checkpoint(tmp_path / "a")
    with open(os.path.join(path, "manifest.json")) as f:
        doc = json.load(f)
    assert "rng_key" not in doc["header"]
    doc["header"]["rng_key"] = [3, 1, 4, 1]
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(doc, f)
    tr2 = _trainer(seed=5)
    tr2.load_checkpoint(tmp_path / "a")
    tr2.step(d, l)
    path = tr2.save_checkpoint(tmp_path / "b")
    with open(os.path.join(path, "manifest.json")) as f:
        assert json.load(f)["header"]["rng_key"] == [3, 1, 4, 1]
    tr2.save_states(str(tmp_path / "s.npz"))
    with onp.load(str(tmp_path / "s.npz"), allow_pickle=False) as z:
        assert json.loads(bytes(z["__header__"]))["rng_key"] == [3, 1, 4, 1]


def test_load_states_tolerates_short_dtypes_header(tmp_path):
    """A states file whose dtypes header lists fewer entries than slots
    still loads, in place."""
    tr = _trainer()
    d, l = _batches(1)[0]
    tr.step(d, l)
    fname = str(tmp_path / "trainer.npz")
    tr.save_states(fname)
    with onp.load(fname, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    header = json.loads(bytes(arrays["__header__"]).decode("utf-8"))
    header["dtypes"] = {k: v[:1] for k, v in header["dtypes"].items()}
    arrays["__header__"] = onp.frombuffer(
        json.dumps(header).encode("utf-8"), dtype=onp.uint8)
    with open(fname, "wb") as f:
        onp.savez(f, **arrays)
    tr2 = _trainer(seed=31)
    ptrs = tr2._state_ptrs()
    tr2.load_states(fname)
    assert tr2.num_update == 1 and tr2._state_ptrs() == ptrs
    for k in tr._pkeys:
        for a, b in zip(tr._opt_state[k], tr2._opt_state[k]):
            assert torch.equal(a, b)


def test_states_refuse_pickle_and_round_trip(tmp_path):
    """No load path runs code from a file: ``SPMDTrainer.load_states`` and
    the Gluon updater refuse a pickle; their own npz round-trips."""
    evil = str(tmp_path / "evil.states")
    with open(evil, "wb") as f:
        pickle.dump({"anything": 1}, f)
    tr = _trainer()
    with pytest.raises(MXNetError, match="pickle"):
        tr.load_states(evil)
    net = nn.Dense(4, in_units=8)
    net.initialize(ctx=mt.cpu())
    gtr = mt.gluon.Trainer(net.collect_params(), "adam",
                           {"learning_rate": 1e-2})
    with mt.autograd.record():
        out = (net(mt.nd.array(onp.ones((2, 8)), ctx=mt.cpu())) ** 2).sum()
    out.backward()
    gtr.step(batch_size=2)
    fname = str(tmp_path / "updater.states")
    gtr.save_states(fname)
    with open(fname, "rb") as f:
        blob = f.read()
    assert blob[:2] == b"PK" and b"c__builtin__" not in blob
    gtr.load_states(fname)
    with pytest.raises(MXNetError, match="pickle"):
        gtr.load_states(evil)


def test_load_rejects_a_mismatched_tree(tmp_path):
    """A leaf of another shape or dtype, or a missing one, raises and
    leaves the trainer as it was."""
    tr = _trainer()
    tr.save_checkpoint(tmp_path / "a")
    other = SPMDTrainer(_wide_net(), gloss.SoftmaxCrossEntropyLoss(),
                        optimizer="adam", device="cpu")
    before = _state(other)
    with pytest.raises(MXNetError, match="shape"):
        other.load_checkpoint(tmp_path / "a")
    _assert_bitwise(_state(other), before)
    leaves, header = checkpoint.load(str(tmp_path / "a"))
    k = tr._pkeys[0]
    leaves[f"param/{k}"] = leaves[f"param/{k}"].double()
    checkpoint.save(str(tmp_path / "b"), leaves, header, block=True)
    with pytest.raises(MXNetError, match="dtype"):
        _trainer(seed=4).load_checkpoint(tmp_path / "b")
    leaves[f"param/{k}"] = leaves[f"param/{k}"].float()
    del leaves[f"opt/{k}/1"]
    checkpoint.save(str(tmp_path / "c"), leaves, header, block=True)
    with pytest.raises(MXNetError, match="optimizer state"):
        _trainer(seed=4).load_checkpoint(tmp_path / "c")


def _wide_net():
    net = nn.HybridSequential()
    net.add(nn.Dense(16, activation="relu"), nn.Dense(4))
    net.initialize(ctx=mt.cpu())
    net(torch.zeros((2, 8)))
    return net


def test_legacy_v1_layout_loads(tmp_path):
    """A directory with ``model.params`` + ``trainer.npz`` (+
    ``meta.json``), the layout before the manifest, still loads."""
    tr = _trainer()
    for d, l in _batches(2):
        tr.step(d, l)
    v1 = tmp_path / "latest"
    v1.mkdir()
    tr.net.save_parameters(str(v1 / "model.params"))
    tr.save_states(str(v1 / "trainer.npz"))
    (v1 / "meta.json").write_text(json.dumps({"fit_seen": 2}))
    tr2 = _trainer(seed=8)
    meta = tr2.load_checkpoint(tmp_path)
    assert meta == {"fit_seen": 2, "num_update": 2}
    _assert_bitwise(_state(tr2), _state(tr))


# -- resume, bitwise, within the port ----------------------------------------------

@pytest.mark.parametrize("opt,bn", [("adam", False), ("sgd", True)],
                         ids=["adam", "sgd-momentum-batchnorm"])
def test_spmd_resume_is_bitwise(opt, bn, tmp_path):
    """k steps, save, load into a fresh net and trainer (other weights),
    k more: losses, masters, states and BatchNorm's running statistics
    bitwise equal to 2k uninterrupted steps."""
    data = _batches(6, seed=3)
    whole = _trainer(opt=opt, bn=bn)
    want = [float(whole.step(d, l)) for d, l in data]
    first = _trainer(opt=opt, bn=bn)
    for d, l in data[:3]:
        first.step(d, l)
    first.save_checkpoint(tmp_path, block=False).result(60)
    second = _trainer(seed=77, opt=opt, bn=bn)
    assert second.load_checkpoint(tmp_path)["num_update"] == 3
    got = [float(second.step(d, l)) for d, l in data[3:]]
    assert got == want[3:]
    _assert_bitwise(_state(second), _state(whole))
    if bn:
        assert any("running_mean" in k for k in second._pkeys)


def test_gluon_trainer_resume_is_bitwise(tmp_path):
    """The eager loop: ``save_parameters`` + ``Trainer.save_states`` after
    k steps; a fresh net and trainer with ``load_parameters`` and
    ``load_states`` take k more steps bitwise equal to an uninterrupted
    run (Adam, with its step count)."""
    rng = onp.random.RandomState(4)
    batches = [(rng.randn(8, 8).astype("float32"),
                rng.randint(0, 4, (8,)).astype("float32")) for _ in range(6)]
    loss_fn = gloss.SoftmaxCrossEntropyLoss()

    def make(seed):
        net = nn.HybridSequential()
        net.add(nn.Dense(16, activation="relu"), nn.Dense(4))
        net.initialize(init=initializer.Xavier(), ctx=mt.cpu(),
                       generator=torch.Generator().manual_seed(seed))
        net(torch.zeros((1, 8)))
        return net, mt.gluon.Trainer(net.collect_params(), "adam",
                                     {"learning_rate": 1e-2})

    def run(net, tr, part):
        out = []
        for x, y in part:
            with mt.autograd.record():
                loss = loss_fn(net(mt.nd.array(x, ctx=mt.cpu())),
                               mt.nd.array(y, ctx=mt.cpu()))
            loss.backward()
            tr.step(8)
            out.append(loss.asnumpy())
        return out

    net, tr = make(0)
    want = run(net, tr, batches)
    net1, tr1 = make(0)
    run(net1, tr1, batches[:3])
    net1.save_parameters(str(tmp_path / "net.params"))
    tr1.save_states(str(tmp_path / "tr.states"))
    net2, tr2 = make(11)
    net2.load_parameters(str(tmp_path / "net.params"))
    tr2.load_states(str(tmp_path / "tr.states"))
    got = run(net2, tr2, batches[3:])
    for g, w in zip(got, want[3:]):
        onp.testing.assert_array_equal(g, w)
    for k, v in convert.collected_params_to_numpy(net2).items():
        onp.testing.assert_array_equal(
            v, convert.collected_params_to_numpy(net)[k])


def test_amp_scaler_state_resumes(tmp_path, monkeypatch):
    """Under the AMP policy the header carries the loss scaler; the load
    writes it into the trainer's device state, and the resumed steps are
    bitwise equal to the uninterrupted ones (an overflowing step halves
    the scale in both)."""
    monkeypatch.setenv("MXNET_AMP", "1")
    data = _batches(5, seed=6)
    bad = data[1][0].clone()
    bad[0, 0] = float("inf")
    data[1] = (bad, data[1][1])

    def run(tr, part):
        return [float(tr.step(d, l)) for d, l in part]

    whole = _trainer(opt="sgd")
    whole._amp_scaler.loss_scale = 16.0
    want = run(whole, data)
    first = _trainer(opt="sgd")
    first._amp_scaler.loss_scale = 16.0
    run(first, data[:2])
    path = first.save_checkpoint(tmp_path)
    with open(os.path.join(path, "manifest.json")) as f:
        amp_hdr = json.load(f)["header"]["amp"]
    assert amp_hdr["scaler"]["loss_scale"] == 8.0
    assert amp_hdr["compute_dtype"] == "bfloat16"
    second = _trainer(seed=2, opt="sgd")
    second.load_checkpoint(tmp_path)
    assert second._amp_scaler.loss_scale == 8.0
    assert run(second, data[2:]) == want[2:]
    _assert_bitwise(_state(second), _state(whole))


# -- across the packages ------------------------------------------------------------

LM_CFG = dict(units=32, num_layers=2, num_heads=4, max_len=32,
              tie_weights=True)
LM_VOCAB, LM_LR, LM_BATCH, LM_SEQ = 64, 3e-4, 8, 32
LM_RNG = onp.random.RandomState(12)
LM_DATA = [(LM_RNG.randint(0, LM_VOCAB, (LM_BATCH, LM_SEQ)).astype("int32"),
            LM_RNG.randint(0, LM_VOCAB, (LM_BATCH, LM_SEQ)).astype("int32"))
           for _ in range(4)]


def _jax_lm_trainer(devices):
    net = JaxLM(LM_VOCAB, **LM_CFG)
    net.initialize(init=mx.initializer.Xavier())
    net(mx.nd.array(onp.zeros((1, 8), onp.int32)))
    return JaxTrainer(net, jax_loss.SoftmaxCrossEntropyLoss(),
                      optimizer="adam",
                      optimizer_params={"learning_rate": LM_LR},
                      mesh=make_mesh({"dp": len(devices)}, devices=devices))


def _port_lm_trainer(seed=0):
    net = TransformerLM(LM_VOCAB, **LM_CFG)
    net.initialize(init=initializer.Xavier(), ctx=mt.cpu(),
                   generator=torch.Generator().manual_seed(seed))
    net(torch.zeros((1, 8), dtype=torch.int32))
    return SPMDTrainer(net, gloss.SoftmaxCrossEntropyLoss(), optimizer="adam",
                       optimizer_params={"learning_rate": LM_LR},
                       device="cpu")


def _jax_params(tr):
    return {k: tr._params[k].data().asnumpy() for k in tr._pkeys}


def test_reference_mesh_checkpoint_resumes_in_the_port(tmp_path):
    """The reference trains 2 steps on the 8-device CPU mesh (dp 8, batch
    8) and saves; the port loads that checkpoint (exactly) and its next
    2 fp32 steps follow the reference's next 2."""
    devices = jax.devices()
    assert len(devices) == 8
    ref = _jax_lm_trainer(devices)
    for d, l in LM_DATA[:2]:
        ref.step(JaxNDArray(d), JaxNDArray(l))
    ref.save_checkpoint(str(tmp_path))
    port = _port_lm_trainer(seed=5)
    assert port.load_checkpoint(tmp_path)["num_update"] == 2
    for k, v in _jax_params(ref).items():
        onp.testing.assert_array_equal(
            port._params[k]._tensor().detach().numpy(), v)
    want = [float(ref.step(JaxNDArray(d), JaxNDArray(l)).asnumpy())
            for d, l in LM_DATA[2:]]
    got = [float(port.step(torch.from_numpy(d), torch.from_numpy(l)))
           for d, l in LM_DATA[2:]]
    onp.testing.assert_allclose(got, want, rtol=1e-4)
    flip = 2 * 2 * 3.17 * LM_LR
    final = convert.collected_params_to_numpy(port.net)
    units = LM_CFG["units"]
    for k, v in _jax_params(ref).items():
        err = onp.abs(final[k] - v)
        assert err.max() <= flip, (k, err.max())
        if k.endswith("attn.qkv.bias"):
            err = onp.concatenate([err[:units], err[2 * units:]])
        assert (err > 1e-5).mean() < 1e-3, (k, (err > 1e-5).mean())


def test_port_checkpoint_loads_into_the_reference(tmp_path):
    """The port's checkpoint (2 steps) loads into the reference's trainer
    exactly (weights and Adam's m and v), which then steps on it."""
    port = _port_lm_trainer()
    for d, l in LM_DATA[:2]:
        port.step(torch.from_numpy(d), torch.from_numpy(l))
    port.save_checkpoint(tmp_path)
    ref = _jax_lm_trainer(jax.devices()[:1])
    meta = ref.load_checkpoint(str(tmp_path))
    assert meta["num_update"] == ref.num_update == 2
    for k in port._pkeys:
        onp.testing.assert_array_equal(
            ref._params[k].data().asnumpy(), port._params[k]._tensor().detach().numpy())
        for a, b in zip(ref._opt_state[k], port._opt_state[k]):
            onp.testing.assert_array_equal(onp.asarray(a), b.numpy())
    d, l = LM_DATA[2]
    loss = float(ref.step(JaxNDArray(d), JaxNDArray(l)).asnumpy())
    assert onp.isfinite(loss) and ref.num_update == 3


# -- the reference's test_elastic.py cases -------------------------------------------

def test_kill_between_publish_renames_leaves_loadable(tmp_path, monkeypatch):
    """Dying between the publish's two renames leaves a loadable
    checkpoint: load falls back to ``.old``."""
    tr = _trainer()
    d, l = _batches(1)[0]
    tr.step(d, l)
    tr.save_checkpoint(tmp_path)
    tr.step(d, l)
    monkeypatch.setenv("MXNET_CKPT_RETRIES", "0")
    final = os.path.abspath(os.path.join(tmp_path, "latest"))
    real_replace = os.replace

    def crash_before_final_rename(src, dst, *a, **kw):
        if os.path.abspath(dst) == final:
            raise OSError("simulated SIGKILL between publish renames")
        return real_replace(src, dst, *a, **kw)

    monkeypatch.setattr(os, "replace", crash_before_final_rename)
    with pytest.raises(MXNetError):
        tr.save_checkpoint(tmp_path)
    monkeypatch.setattr(os, "replace", real_replace)
    assert not os.path.exists(final)
    meta = _trainer(seed=11).load_checkpoint(tmp_path)
    assert meta and meta["num_update"] == 1


def test_corrupted_shard_raises_clear_error(tmp_path):
    tr = _trainer()
    path = tr.save_checkpoint(tmp_path)
    victim = os.path.join(path, "shard-d0.npz")
    with open(victim, "r+b") as f:
        f.truncate(os.path.getsize(victim) // 2)
    with pytest.raises(MXNetError, match="checkpoint|shard"):
        _trainer(seed=2).load_checkpoint(tmp_path)


def test_truncated_manifest_raises(tmp_path):
    tr = _trainer()
    path = tr.save_checkpoint(tmp_path)
    with open(os.path.join(path, "manifest.json"), "w") as f:
        f.write('{"format": "mxnet_tpu-checkpoint-v2", "leav')
    with pytest.raises(MXNetError, match="manifest"):
        _trainer(seed=2).load_checkpoint(tmp_path)


def test_async_save_failure_degrades_gracefully(tmp_path, monkeypatch):
    """A failing async save logs and counts ``checkpoint.failures`` and
    never raises into training; blocking, it raises."""
    monkeypatch.setenv("MXNET_CKPT_RETRIES", "1")
    monkeypatch.setenv("MXNET_CKPT_BACKOFF_MS", "1")
    tr = _trainer()
    d, l = _batches(1)[0]
    tr.step(d, l)
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("a file where a directory must go")
    target = blocker / "ckpt"
    before = telemetry.counter("checkpoint.failures").value
    job = tr.save_checkpoint(str(target), block=False)
    job.wait(timeout=60)
    assert job.error is not None
    assert telemetry.counter("checkpoint.failures").value == before + 1
    tr.step(d, l)
    assert tr.num_update == 2
    with pytest.raises(MXNetError):
        tr.save_checkpoint(str(target), block=True)


def _save_np(d, step, **kw):
    """A one-leaf checkpoint whose payload is its step."""
    tree = {"w": onp.full((4, 4), float(step), "float32")}
    return checkpoint.save(str(d), tree, header={"num_update": step},
                           block=kw.pop("block", True), **kw)


def _assert_loaded_step(d, step):
    leaves, header = checkpoint.load(str(d))
    assert header["num_update"] == step
    onp.testing.assert_array_equal(
        leaves["w"].numpy(), onp.full((4, 4), float(step), "float32"))


def test_two_rank_commit_barrier_roundtrip(tmp_path, monkeypatch):
    """Threads as ranks: each rank writes its own leaves, rank 0 merges
    the markers' fragments into one manifest, rank 1 returns once that
    publish lands; rank and world come from the environment when not
    given."""
    monkeypatch.setenv("MXNET_CKPT_BARRIER_TIMEOUT_S", "30")
    j0 = checkpoint.save(str(tmp_path), {"w0": onp.ones((2, 3), "float32")},
                         header={"num_update": 1}, block=False,
                         rank=0, world=2)
    j1 = checkpoint.save(str(tmp_path),
                         {"w1": torch.full((3,), 2.0, dtype=torch.bfloat16)},
                         header={"num_update": 1}, block=False,
                         rank=1, world=2)
    assert j0.result(60) == j1.result(60)
    leaves, header = checkpoint.load(str(tmp_path))
    assert sorted(leaves) == ["w0", "w1"] and header["num_update"] == 1
    assert leaves["w1"].dtype == torch.bfloat16
    with open(tmp_path / "latest" / "manifest.json") as f:
        doc = json.load(f)
    assert doc["world"] == 2
    assert sorted(doc["files"]) == ["shard-r0-d0.npz", "shard-r1-d0.npz"]
    assert telemetry.histogram("checkpoint.barrier_wait_ms").count >= 2


def test_rank_world_resolution(monkeypatch):
    """Environment > ``set_rank`` > (0, 1) here (no process group)."""
    monkeypatch.delenv("MXNET_CKPT_RANK", raising=False)
    monkeypatch.setattr(checkpoint, "_rank_override", None)
    assert checkpoint.rank_world() == (0, 1)
    checkpoint.set_rank(1, 4)
    assert checkpoint.rank_world() == (1, 4)
    monkeypatch.setenv("MXNET_CKPT_RANK", "2")
    monkeypatch.setenv("MXNET_CKPT_WORLD", "3")
    assert checkpoint.rank_world() == (2, 3)
    monkeypatch.setenv("MXNET_CKPT_RANK", "x")
    with pytest.raises(MXNetError, match="MXNET_CKPT_RANK"):
        checkpoint.rank_world()


def test_rank_death_before_marker_blocks_publish(tmp_path, monkeypatch):
    """Rank 1 dying before its ready marker makes rank 0 time out without
    publishing: the previous checkpoint stays the loadable one."""
    _save_np(tmp_path, 1)
    monkeypatch.setenv("MXNET_CKPT_RETRIES", "0")
    monkeypatch.setenv("MXNET_CKPT_BARRIER_TIMEOUT_S", "1.5")
    monkeypatch.setenv("MXNET_FAULT_SPEC", "marker_write@1:1")
    fails = telemetry.counter("checkpoint.failures").value
    j0 = checkpoint.save(str(tmp_path), {"w": onp.zeros(2, "float32")},
                         header={"num_update": 2}, block=False,
                         rank=0, world=2)
    j1 = checkpoint.save(str(tmp_path), {"v": onp.ones(2, "float32")},
                         header={"num_update": 2}, block=False,
                         rank=1, world=2)
    j0.wait(60), j1.wait(60)
    assert isinstance(j1.error, faultinject.FaultInjected)
    assert j0.error is not None and "barrier" in str(j0.error)
    assert telemetry.counter("checkpoint.failures").value == fails + 2
    _assert_loaded_step(tmp_path, 1)


def test_rank0_death_after_barrier_blocks_publish(tmp_path, monkeypatch):
    """Rank 0 dying between collecting the markers and the manifest:
    nothing publishes, rank 1's wait expires, and a restarted save of the
    same step goes through."""
    _save_np(tmp_path, 1)
    monkeypatch.setenv("MXNET_CKPT_RETRIES", "0")
    monkeypatch.setenv("MXNET_CKPT_BARRIER_TIMEOUT_S", "1.5")
    monkeypatch.setenv("MXNET_FAULT_SPEC", "commit@0:1")

    def both():
        j0 = checkpoint.save(str(tmp_path), {"w": onp.zeros(2, "float32")},
                             header={"num_update": 2}, block=False,
                             rank=0, world=2)
        j1 = checkpoint.save(str(tmp_path), {"v": onp.ones(2, "float32")},
                             header={"num_update": 2}, block=False,
                             rank=1, world=2)
        return j0, j1

    j0, j1 = both()
    j0.wait(60), j1.wait(60)
    assert isinstance(j0.error, faultinject.FaultInjected)
    assert j0.error.site == "commit"
    assert isinstance(j1.error, MXNetError) and "timed out" in str(j1.error)
    _assert_loaded_step(tmp_path, 1)
    monkeypatch.setenv("MXNET_CKPT_RETRIES", "2")
    j0, j1 = both()
    j0.result(60), j1.result(60)
    leaves, header = checkpoint.load(str(tmp_path))
    assert header["num_update"] == 2 and sorted(leaves) == ["v", "w"]


@pytest.mark.parametrize("spec", [
    "shard_write:1", "fsync:1", "manifest_write:1",
    "rename:1",                     # before latest → latest.old
    "rename:2",                     # torn: after latest → latest.old
])
def test_single_failure_invariant(tmp_path, monkeypatch, spec):
    """Under any single injected failure (retries off),
    ``load("latest")`` returns the previous published checkpoint; with
    retries on, the same failure heals."""
    _save_np(tmp_path, 1)
    monkeypatch.setenv("MXNET_CKPT_RETRIES", "0")
    monkeypatch.setenv("MXNET_FAULT_SPEC", spec)
    with pytest.raises(MXNetError):
        _save_np(tmp_path, 2, block=True)
    assert faultinject.hits(spec.split(":")[0]) >= 1
    _assert_loaded_step(tmp_path, 1)
    monkeypatch.setenv("MXNET_CKPT_RETRIES", "2")
    monkeypatch.setenv("MXNET_FAULT_SPEC", spec + ",")  # counters reset
    _save_np(tmp_path, 3, block=True)
    _assert_loaded_step(tmp_path, 3)


def test_fault_spec_grammar():
    """Rules are ``site[@rank]:occurrence[:action]``; bad rules raise;
    the Nth matching call fires, earlier and later ones pass."""
    assert faultinject.active_spec() is None     # no MXNET_FAULT_SPEC
    for bad in ("shard_write", "shard_write:0", "x@y:1", "x:1:explode",
                "x:one"):
        with pytest.raises(MXNetError):
            faultinject.configure(bad)
    faultinject.configure("s:2,t@1:1")
    assert faultinject.active_spec() == "s:2,t@1:1"
    faultinject.fire("s")
    with pytest.raises(faultinject.FaultInjected) as ei:
        faultinject.fire("s")
    assert ei.value.site == "s" and ei.value.occurrence == 2
    faultinject.fire("s")
    faultinject.fire("t", rank=0)
    with pytest.raises(faultinject.FaultInjected):
        faultinject.fire("t", rank=1)
    assert faultinject.hits("s") == 3 and faultinject.hits("t") == 2
    faultinject.clear()
    faultinject.fire("s")
    assert faultinject.hits("s") == 0


def test_gc_keeps_last_n(tmp_path, monkeypatch):
    """``MXNET_CKPT_KEEP=3``: after six publishes the live tag and the two
    newest step dirs remain; the history is itself loadable."""
    monkeypatch.setenv("MXNET_CKPT_KEEP", "3")
    removed = telemetry.counter("checkpoint.gc_removed").value
    for step in range(1, 7):
        _save_np(tmp_path, step)
    entries = sorted(e for e in os.listdir(tmp_path)
                     if not e.startswith("."))
    assert entries == ["latest", "step-4", "step-5"]
    assert telemetry.counter("checkpoint.gc_removed").value == removed + 3
    _assert_loaded_step(tmp_path, 6)
    assert checkpoint.load(str(tmp_path / "step-4"), ".")[1][
        "num_update"] == 4
    assert [s for s, _ in checkpoint.step_history(str(tmp_path))] == [5, 4]


def test_gc_never_touches_inflight_target(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_CKPT_KEEP", "2")
    for step in range(1, 4):
        _save_np(tmp_path, step)
    assert (tmp_path / "step-2").is_dir()
    snap = checkpoint.snapshot({"w": onp.zeros(1, "float32")}, {})
    pin = checkpoint.PendingSave(str(tmp_path), "step-2", snap)
    with checkpoint._LOCK:
        checkpoint._PENDING.append(pin)
    try:
        assert checkpoint_gc.collect(str(tmp_path), keep=1) == 0
        assert (tmp_path / "step-2").is_dir()
    finally:
        with checkpoint._LOCK:
            checkpoint._PENDING.remove(pin)
    assert checkpoint_gc.collect(str(tmp_path), keep=1) == 1
    assert not (tmp_path / "step-2").exists()


def test_coalescing_drops_a_queued_save_of_the_same_target(tmp_path):
    """A queued save that has not started is superseded by a newer
    snapshot of the same target, and counted."""
    gate = threading.Event()
    blocker = checkpoint.PendingSave(str(tmp_path / "x"), "latest",
                                     checkpoint.snapshot({}, {}), rank=7)
    coalesced = telemetry.counter("checkpoint.coalesced").value
    real = checkpoint._run_job

    def held(job):
        if job is blocker:
            gate.wait(30)
        return real(job)

    checkpoint._run_job = held
    try:
        checkpoint._submit(blocker)
        old = checkpoint.save(str(tmp_path), {"w": onp.zeros(2, "float32")},
                              header={"num_update": 1}, block=False, rank=7)
        new = checkpoint.save(str(tmp_path), {"w": onp.ones(2, "float32")},
                              header={"num_update": 2}, block=False, rank=7)
        gate.set()
        new.result(60)
        old.wait(60)
    finally:
        checkpoint._run_job = real
    assert old.superseded
    with pytest.raises(MXNetError, match="superseded"):
        old.result(1)
    assert telemetry.counter("checkpoint.coalesced").value == coalesced + 1
    leaves, header = checkpoint.load(str(tmp_path))
    assert header["num_update"] == 2


def test_snapshot_is_safe_from_later_in_place_updates(tmp_path):
    """What a save writes is the value at the snapshot, though the tensor
    is overwritten before the writer runs."""
    t = torch.ones(3)
    snap = checkpoint.snapshot({"t": t}, {"num_update": 1})
    t.mul_(5)
    checkpoint.save(str(tmp_path), snap, block=True)
    onp.testing.assert_array_equal(
        checkpoint.load(str(tmp_path))[0]["t"].numpy(), onp.ones(3))


def test_hand_built_sharded_checkpoint_reassembles(tmp_path):
    """The resharded restore: a leaf written as two row slices in two
    shard files (as the reference writes a leaf sharded over two
    devices) loads as its global array, with every digest checked, and
    into a trainer; a slice's digest mismatch names its file."""
    tr = _trainer()
    for d, l in _batches(2):
        tr.step(d, l)
    path = tr.save_checkpoint(tmp_path)
    want = _state(tr)
    with open(os.path.join(path, "manifest.json")) as f:
        doc = json.load(f)
    name = f"param/{tr._pkeys[0]}"
    full = want[name].numpy()
    half = full.shape[0] // 2
    files = {}
    for dev, (a, b) in enumerate(((0, half), (half, full.shape[0]))):
        fname = f"shard-d{dev + 1}.npz"
        with open(os.path.join(path, fname), "wb") as f:
            onp.savez(f, a0=full[a:b])
        files[fname] = {"sha256": checkpoint._sha256_file(
            os.path.join(path, fname))}
        files[fname]["bytes"] = os.path.getsize(os.path.join(path, fname))
    doc["leaves"][name]["shards"] = [
        {"file": "shard-d1.npz", "key": "a0", "start": [0, 0],
         "stop": [half, full.shape[1]]},
        {"file": "shard-d2.npz", "key": "a0", "start": [half, 0],
         "stop": list(full.shape)}]
    doc["files"].update(files)
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(doc, f)
    leaves, _ = checkpoint.load(str(tmp_path))
    assert torch.equal(leaves[name], want[name])
    tr2 = _trainer(seed=6)
    tr2.load_checkpoint(tmp_path)
    _assert_bitwise(_state(tr2), want)
    raw = bytearray(open(os.path.join(path, "shard-d2.npz"), "rb").read())
    raw[-30] ^= 0x04
    with open(os.path.join(path, "shard-d2.npz"), "wb") as f:
        f.write(bytes(raw))
    with pytest.raises(MXNetError, match="digest mismatch") as ei:
        checkpoint.load(str(tmp_path))
    assert "shard-d2.npz" in str(ei.value)


def test_digest_mismatch_names_offending_shard(tmp_path):
    path = _save_np(tmp_path, 1).result()
    victim = os.path.join(path, "shard-d0.npz")
    raw = bytearray(open(victim, "rb").read())
    raw[len(raw) // 2] ^= 0x01
    with open(victim, "wb") as f:
        f.write(bytes(raw))
    with pytest.raises(MXNetError, match="digest mismatch") as ei:
        checkpoint.load(str(tmp_path))
    assert "shard-d0.npz" in str(ei.value)


def test_verify_and_heal_quarantines_corrupt_checkpoint(tmp_path):
    for step in (1, 2):
        _save_np(tmp_path, step)
    vp = telemetry.counter("checkpoint.verify_passes").value
    vf = telemetry.counter("checkpoint.verify_failures").value
    assert checkpoint_gc.verify_and_heal(str(tmp_path)) is True
    assert telemetry.counter("checkpoint.verify_passes").value == vp + 1
    victim = tmp_path / "latest" / "shard-d0.npz"
    raw = bytearray(victim.read_bytes())
    raw[-5] ^= 0x10
    victim.write_bytes(bytes(raw))
    report = checkpoint_gc.verify_checkpoint(str(tmp_path))
    assert not report["ok"] and report["bad"] == ["shard-d0.npz"]
    assert checkpoint_gc.verify_and_heal(str(tmp_path)) is False
    assert telemetry.counter("checkpoint.verify_failures").value == vf + 1
    assert not (tmp_path / "latest").exists()
    assert [e for e in os.listdir(tmp_path) if "quarantine" in e]
    _assert_loaded_step(tmp_path, 1)


def test_background_verifier_thread_heals(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_CKPT_VERIFY_SEC", "0.05")
    for step in (1, 2):
        _save_np(tmp_path, step)
    victim = tmp_path / "latest" / "shard-d0.npz"
    raw = bytearray(victim.read_bytes())
    raw[len(raw) // 3] ^= 0x80
    victim.write_bytes(bytes(raw))
    deadline = time.monotonic() + 30
    while (tmp_path / "latest").exists():
        assert time.monotonic() < deadline, \
            "background verifier never quarantined the corrupt checkpoint"
        time.sleep(0.05)
    _assert_loaded_step(tmp_path, 1)
    checkpoint_gc.stop()
    assert checkpoint_gc._thread is None


def test_load_scan_fallback_logs_which_checkpoint(tmp_path, caplog):
    for step in (1, 2, 3):
        _save_np(tmp_path, step)
    shutil.rmtree(tmp_path / "latest")
    assert not (tmp_path / "latest.old").exists()
    with caplog.at_level("WARNING", logger="mxnet_tpu_torch.checkpoint"):
        _assert_loaded_step(tmp_path, 2)
    assert any("fell back to retained history" in r.message
               and "step-2" in r.message for r in caplog.records)


def test_environment_switches_are_validated(monkeypatch):
    for name in ("MXNET_CKPT_RETRIES", "MXNET_CKPT_BACKOFF_MS",
                 "MXNET_CKPT_BARRIER_TIMEOUT_S"):
        monkeypatch.setenv(name, "soon")
        with pytest.raises(MXNetError, match=name):
            {"MXNET_CKPT_RETRIES": checkpoint._retries,
             "MXNET_CKPT_BACKOFF_MS": checkpoint._backoff_s,
             "MXNET_CKPT_BARRIER_TIMEOUT_S":
                 checkpoint._barrier_timeout_s}[name]()
        monkeypatch.delenv(name)
    assert checkpoint._retries() == 3
    assert checkpoint._backoff_s() == 0.05
    monkeypatch.setenv("MXNET_CKPT_KEEP", "-2")
    assert checkpoint_gc.keep_n() == 0
