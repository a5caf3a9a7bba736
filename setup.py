"""Packaging for drake_tpu (the reference's Bazel/CMake build role,
SURVEY §2.8: tools/skylark/drake_cc.bzl, CMakeLists.txt).

The only native component is the pub/sub transport
(drake_tpu/io/native/pubsub.cpp).  It is normally compiled lazily on first
import (g++ -shared, see drake_tpu/io/pubsub.py); ``build_ext`` here
pre-compiles it into the package tree so installed environments don't need
a toolchain at runtime.  Everything else is pure Python on JAX.
"""

import subprocess
from pathlib import Path

from setuptools import Command, find_packages, setup


class BuildNative(Command):
    """Compile drake_tpu/io/native/pubsub.cpp -> pubsub.so in-place."""

    description = "compile the native pub/sub transport"
    user_options = []

    def initialize_options(self):
        pass

    def finalize_options(self):
        pass

    def run(self):
        src = Path(__file__).parent / "drake_tpu" / "io" / "native" / "pubsub.cpp"
        out = src.with_suffix(".so")
        subprocess.check_call(
            ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", str(src), "-o", str(out)]
        )
        print(f"built {out}")


setup(
    name="drake_tpu",
    version="0.2.0",
    description=(
        "TPU-native model-based control / trajectory optimization / MPM "
        "framework (JAX/XLA/Pallas) with the capabilities of g1n0st/drake"
    ),
    packages=find_packages(
        include=["drake_tpu", "drake_tpu.*", "drake_tpu_torch", "drake_tpu_torch.*"]
    ),
    package_data={
        "drake_tpu.io": ["native/*.cpp", "native/*.so"],
        # The PyTorch port's CUDA sources, built with nvcc at first use.
        "drake_tpu_torch.ops": ["csrc/*.cu"],
    },
    python_requires=">=3.10",
    install_requires=["jax", "numpy", "pyyaml"],
    cmdclass={"build_native": BuildNative},
)
