"""Packaging: builds the native ingest library alongside the Python
package (the reference used a torch CUDAExtension, setup.py:28-134; here
the native piece is a plain shared library consumed via ctypes)."""
import os
import subprocess

from setuptools import setup
from setuptools.command.build_py import build_py


class BuildWithNative(build_py):
    def run(self):
        csrc = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
        subprocess.run(["make", "-C", csrc], check=True)
        super().run()


setup(
    name="tensor-stream-tpu",
    version="0.1.0",
    description="TPU-native video-to-tensor streaming (jax.Array out)",
    packages=["tensor_stream_tpu", "tensor_stream_tpu.ops",
              "tensor_stream_tpu.models", "tensor_stream_tpu.parallel",
              "tensor_stream_tpu.utils",
              # The PyTorch/CUDA port; its CUDA sources build at first use.
              "tensor_stream_torch", "tensor_stream_torch.ops",
              "tensor_stream_torch.utils"],
    package_data={"tensor_stream_torch": ["csrc/*.cu"]},
    python_requires=">=3.10",
    install_requires=["jax", "numpy", "flax", "optax"],
    cmdclass={"build_py": BuildWithNative},
)
