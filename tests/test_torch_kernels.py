"""The port's kernel registry, autotune cache and tuner
(mxnet_tpu_torch.kernels): resolution order, the on-disk format shared
with the reference package, and that tuning never times a plain version
in place of a kernel."""
import json

import pytest
import torch

from mxnet_tpu.kernels import cache as jax_cache

from mxnet_tpu_torch import kernels
from mxnet_tpu_torch.kernels import registry
from mxnet_tpu_torch.ops import paged_attention as pa_mod  # noqa: F401
from mxnet_tpu_torch.ops import rope as rope_mod  # noqa: F401


@pytest.fixture
def cache_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_KERNEL_CACHE_DIR", str(tmp_path))
    kernels.invalidate()
    yield tmp_path
    monkeypatch.delenv("MXNET_KERNEL_CACHE_DIR")
    kernels.invalidate()


def test_cache_key_names_backend_and_version():
    spec = kernels.get_kernel("rope")
    key = kernels.cache_key(spec, "r64_h8_d64", "float32")
    backend, ndev = registry._topology()
    assert key == (f"rope|v{spec.version}|{backend}|ndev{ndev}|float32|"
                   f"r64_h8_d64")
    assert backend == "cpu" or backend.startswith("cuda:")


def test_resolve_default_then_disk_then_warm(cache_dir):
    spec = kernels.get_kernel("paged_attention")
    misses = kernels.stats()["cache_misses"]
    assert kernels.resolve("paged_attention", "sigA", "float32") == \
        spec.default_config
    assert kernels.stats()["cache_misses"] == misses + 1
    key = kernels.commit(spec, "sigB", "float32", {"warps": 4}, ms=0.02)
    kernels.invalidate()
    hits = kernels.stats()["cache_hits"]
    assert kernels.resolve("paged_attention", "sigB", "float32") == \
        {"warps": 4}
    assert kernels.stats()["cache_hits"] == hits + 1
    kernels.invalidate()
    assert kernels.warm_cache() == 1
    doc = json.loads((cache_dir / "kernel_cache.json").read_text())
    assert doc["entries"][key]["config"] == {"warps": 4}


@pytest.mark.parametrize("config", [{"pairs": 8, "threads": 64},
                                    {"pairs": 2, "threads": 256}])
def test_on_disk_format_is_the_reference_packages(cache_dir, config):
    """One cache file can serve both packages: the reference's loader
    reads what the port wrote, and the backend field keeps the entries
    apart."""
    spec = kernels.get_kernel("rope")
    key = kernels.commit(spec, "r64_h8_d64", "float32", config)
    assert jax_cache.load()[key]["config"] == config


def test_corrupt_cache_file_reads_as_empty(cache_dir):
    (cache_dir / "kernel_cache.json").write_text("{not json")
    assert kernels.cache.load() == {}
    assert kernels.resolve("rope", "r8", "float32") == \
        kernels.get_kernel("rope").default_config


def test_tuning_cpu_tensors_times_no_plain_version():
    """Every candidate launches the kernel; on CPU tensors each one
    refuses, so the tuner keeps the default and reports why."""
    spec = kernels.get_kernel("rope")
    arrays, params = spec.make_args({"r": 8, "h": 2, "d": 8,
                                     "device": "cpu"})
    cfg, ms, rows = kernels.tune(spec, arrays, params=params)
    assert cfg == spec.default_config and ms == 0.0
    assert len(rows) == len(kernels.candidates(spec))
    assert all(r["ms"] is None and "CUDA" in r["error"] for r in rows)


def test_time_ms_on_host():
    x = torch.ones(16)
    assert kernels.time_ms(lambda: x.sum(), torch.device("cpu"), 1, 3) >= 0
