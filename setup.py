"""Packaging (parity: python/setup.py + tools/pip of the reference).

Builds the native runtime (src_native → mxnet_tpu/lib/libmxtpu_io.so)
as part of the wheel/sdist so the data pipeline and dependency engine
ship compiled, the way the reference packages libmxnet.so.
"""
import os
import subprocess

from setuptools import setup, find_packages
from setuptools.command.build_py import build_py


class BuildWithNative(build_py):
    def run(self):
        src = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "src_native")
        if os.path.isdir(src):
            subprocess.run(["make", "-C", src], check=True)
        super().run()


setup(
    name="mxnet-tpu",
    version="0.1.0",
    description=("TPU-native deep learning framework with the MXNet "
                 "capability surface (JAX/XLA/Pallas backend)"),
    packages=find_packages(include=["mxnet_tpu", "mxnet_tpu.*",
                                    "mxnet_tpu_torch", "mxnet_tpu_torch.*"]),
    package_data={"mxnet_tpu": ["lib/*.so"],
                  "mxnet_tpu_torch": ["csrc/*.cu"]},
    python_requires=">=3.10",
    install_requires=["jax", "numpy", "ml_dtypes"],
    extras_require={"onnx": ["protobuf>=3.20"]},
    cmdclass={"build_py": BuildWithNative},
)
