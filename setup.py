"""Build/install for apex_tpu (reference: the optional-extension setup.py).

Unlike the reference there are no --cpp_ext/--cuda_ext flags for the
compute path — TPU kernels are Pallas programs JIT-compiled by Mosaic, so a
plain Python install is the full-performance install.  The optional native
host runtime (flatten/bucket planner + data pipeline, apex_tpu/_native) is
built with `python setup.py build_native` (plain g++, loaded via ctypes);
without it the pure-Python fallbacks are used, mirroring the reference's
graceful degradation (README.md:90-95).

It also installs ``apex_tpu_torch``, the PyTorch / NVIDIA Hopper port,
with its CUDA C++ sources; those are compiled by ``nvcc`` on the machine
with the GPU at first use, not here.
"""

import os
import subprocess
import sys

from setuptools import Command, find_packages, setup


class BuildNative(Command):
    description = "build the C++ host-runtime library (apex_tpu/_native)"
    user_options = []

    def initialize_options(self):
        pass

    def finalize_options(self):
        pass

    def run(self):
        here = os.path.dirname(os.path.abspath(__file__))
        script = os.path.join(here, "apex_tpu", "_native", "build.sh")
        subprocess.check_call(["bash", script])


setup(
    name="apex_tpu",
    version="0.1.0",
    description="TPU-native mixed-precision and distributed training "
                "toolkit (Apex-equivalent on JAX/XLA/Pallas)",
    packages=find_packages(include=["apex_tpu", "apex_tpu.*",
                                    "apex_tpu_torch", "apex_tpu_torch.*"]),
    # the port's CUDA sources, built by nvcc at first use (ops/_build.py)
    package_data={"apex_tpu_torch.ops": ["csrc/*.cu", "csrc/*.cuh"]},
    python_requires=">=3.10",
    install_requires=["jax", "numpy"],
    cmdclass={"build_native": BuildNative},
)
