"""apex_tpu_torch: the PyTorch / NVIDIA Hopper port of apex_tpu.

The same toolkit as ``apex_tpu`` (amp O0-O3, fp32 master weights, loss
scaling, fused optimizers), written in PyTorch for an H100.  Every Pallas
kernel of ``apex_tpu/ops`` that the port covers is a CUDA C++ kernel of
``ops/csrc`` built with ``nvcc`` at first use and bound with ``ctypes``.

The package never imports ``jax`` or ``apex_tpu``.  Importing it builds
nothing and imports no subpackage: ``from apex_tpu_torch import amp`` (or
``optimizers``, ``models``, ...) loads what it names.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no GPU and no explicit CPU request they raise.  Kernel dispatch is
by the tensor's device alone: a CUDA tensor launches the kernel (or
raises), a CPU tensor takes the kernel's plain PyTorch version.
"""

import importlib

__version__ = "0.1.0"

_SUBPACKAGES = ("amp", "data", "lora", "models", "multi_tensor_apply", "nn",
                "normalization", "ops", "optimizers", "parallel",
                "quantization", "transformer", "utils")

__all__ = list(_SUBPACKAGES) + ["resolve_device"]


def __getattr__(name):
    if name in _SUBPACKAGES:
        return importlib.import_module(f"{__name__}.{name}")
    if name == "resolve_device":
        from ._device import resolve_device
        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
