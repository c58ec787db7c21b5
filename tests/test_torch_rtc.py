"""The port's runtime kernels (mxnet_tpu_torch.rtc, K7) and the nvcc
build layer they use (mxnet_tpu_torch.kernels.build).

What runs here, without nvcc or a GPU: the kernel-name parsing and every
error the contract promises before a launch (unknown name, wrong number
of inputs, CPU NDArrays, bad grid), the cubin cache and the parallel
library builds against a stand-in compiler, and the reference's Pallas
``axpy`` against the torch expression chip_smoke.py holds the CUDA
``axpy`` to (bitwise: ``2*x`` is exact, so both round once).
"""
import os
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx

import chip_smoke
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import rtc
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.kernels import build

SRC = r'''
// extern "C" __global__ void commented_out(float* out, long long n) {}
extern "C" __global__ void axpy(const float* x, const float* y,
                                float* out, long long n) {
    long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (i < n) out[i] = 2.0f * x[i] + y[i];
}
extern "C" __global__ __launch_bounds__(256) void fill(float* out,
                                                      long long n) {}
__global__ void internal(float* out) {}
/* extern "C" __global__ void also_commented(float* o, long long n) {} */
'''


def test_module_parses_exported_kernels_without_a_compiler():
    mod = rtc.CudaModule(SRC)
    assert mod.names == ("axpy", "fill")
    assert rtc.CudaModule(SRC, exports=["fill"]).names == ("fill",)
    assert rtc.CudaModule(chip_smoke.RTC_SOURCE).names == (
        "axpy", "axpy_strided")
    with pytest.raises(MXNetError, match="not declared"):
        rtc.CudaModule(SRC, exports=["internal"])
    with pytest.raises(MXNetError, match="declares no"):
        rtc.CudaModule("__global__ void k(float* o) {}")
    with pytest.raises(MXNetError, match="nope"):
        mod.get_kernel("nope")


def test_launch_errors_come_before_any_compile():
    mod = rtc.CudaModule(SRC)
    k = mod.get_kernel("axpy", num_inputs=2)
    a = mx.nd.ones((4,), ctx=mx.cpu())
    with pytest.raises(MXNetError, match="expects 2 inputs, got 1"):
        k.launch([a], out_shape=(4,))
    with pytest.raises(MXNetError, match="no plain version"):
        k.launch([a, a], out_shape=(4,))
    with pytest.raises(MXNetError, match="NDArrays"):
        k.launch([a, torch.ones(4)], out_shape=(4,))
    assert mod._cubin is None and k.launches == 0 and rtc.launches == 0


def test_grid():
    assert rtc._grid(1000, None) == (4, 1, 1)
    assert rtc._grid(256, None) == (1, 1, 1)
    assert rtc._grid(10 ** 6, 7) == (7, 1, 1)
    assert rtc._grid(10, (2, 3)) == (2, 3, 1)
    for bad in (0, (1, 2, 3, 4), (2, -1), 1.5):
        with pytest.raises(MXNetError, match="grid"):
            rtc._grid(10, bad)


def test_reference_axpy_equals_the_chip_oracle_bitwise():
    pallas = ("def axpy(x_ref, y_ref, o_ref):\n"
              "    o_ref[...] = 2.0 * x_ref[...] + y_ref[...]\n")
    rng = onp.random.RandomState(0)
    x = rng.randn(8, 2, 16).astype(onp.float32)
    y = rng.randn(8, 2, 16).astype(onp.float32)
    k = jmx.rtc.PallasModule(pallas).get_kernel("axpy", num_inputs=2)
    ref = k.launch([jmx.nd.array(x), jmx.nd.array(y)], out_shape=x.shape)
    got = chip_smoke.axpy_oracle(torch.from_numpy(x), torch.from_numpy(y))
    onp.testing.assert_array_equal(got.numpy(), ref.asnumpy())


def _fake_nvcc(monkeypatch, tmp_path, hook=lambda cmd: None):
    """nvcc stands in as a function that writes its ``-o`` file."""
    monkeypatch.setattr(build, "build_dir", lambda: str(tmp_path / "out"))
    monkeypatch.setattr(build, "_nvcc", lambda: "nvcc")
    calls = []

    def run(cmd, **kw):
        calls.append(cmd)
        err = hook(cmd)
        if err:
            return subprocess.CompletedProcess(cmd, 1, "", err)
        with open(cmd[cmd.index("-o") + 1], "wb") as f:
            f.write(b"\0")
        return subprocess.CompletedProcess(cmd, 0, "ptxas info", "")

    monkeypatch.setattr(build.subprocess, "run", run)
    return calls


def test_library_builds_of_two_sources_run_at_once(tmp_path, monkeypatch):
    """Each build holds only its own source's lock, so chip_smoke's
    parallel builds really overlap (one lock over every build made them
    run one after another)."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("one", "two"):
        (csrc / f"{name}.cu").write_text(f"// {name}\n")
    monkeypatch.setattr(build, "_CSRC", str(csrc))
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: path)
    both_running = threading.Barrier(2, timeout=10)
    _fake_nvcc(monkeypatch, tmp_path, lambda cmd: both_running.wait() and
               None)
    with ThreadPoolExecutor(2) as ex:
        results = list(ex.map(build.build_library, ("one", "two")))
    names = [os.path.basename(lib).split("-")[0] for lib, _, _ in results]
    assert names == ["libone", "libtwo"]
    assert all(log == "ptxas info" for _, log, _ in results)
    assert build.build_library("one") is results[0]


def test_build_cubin_names_by_hash_caches_and_raises(tmp_path, monkeypatch):
    calls = _fake_nvcc(monkeypatch, tmp_path, lambda cmd: (
        "error: expected a ';'" if "broken" in open(cmd[-1]).read()
        else None))
    path, log, _ = build.build_cubin(SRC)
    assert os.path.dirname(path) == str(tmp_path / "out" / "rtc")
    assert path.endswith(".cubin") and os.path.exists(path)
    assert calls[0][:len(build.CUBIN_FLAGS) + 1] == ["nvcc",
                                                     *build.CUBIN_FLAGS]
    assert build.build_cubin(SRC) == (path, "", 0.0) and len(calls) == 1
    other, _, _ = build.build_cubin(SRC, options=("-DSCALE=3",))
    assert other != path and "-DSCALE=3" in calls[1]
    with pytest.raises(MXNetError, match="expected a ';'"):
        build.build_cubin("broken")
    assert not list((tmp_path / "out" / "rtc").glob("*.tmp"))
