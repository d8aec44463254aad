"""amp frontend: the opt-level system and ``amp.initialize``.

Counterpart of ``apex_tpu/amp/frontend.py``: a ``Properties`` option
struct validated in ``__setattr__``, the O0-O3 presets, and
``initialize()``, which applies a preset and then the user's overrides.
``half_dtype`` picks bfloat16 (the default) or float16; under bfloat16 a
preset's "dynamic" loss scale becomes a static 1.0, because bf16 has
fp32's exponent range.

O1 inserts casts at op boundaries by a cast policy, which this slice
does not port: ``opt_level="O1"`` raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any

import torch

from ._amp_state import _amp_state, maybe_print, warn_or_err

__all__ = ["Properties", "O0", "O1", "O2", "O3", "opt_levels", "initialize"]

_HALF_DTYPES = {"float16": torch.float16, "bfloat16": torch.bfloat16,
                "fp16": torch.float16, "bf16": torch.bfloat16}


class Properties:
    """Options struct with validation (frontend.py:30-109 of the JAX
    package)."""

    def __init__(self):
        self.options = {
            "enabled": False,
            "opt_level": None,
            "cast_model_type": None,
            "patch_torch_functions": False,
            "keep_batchnorm_fp32": None,
            "master_weights": None,
            "loss_scale": 1.0,
            "cast_model_outputs": None,
            "num_losses": 1,
            "verbosity": 1,
            "min_loss_scale": None,
            "max_loss_scale": 2. ** 24,
            "half_dtype": "bfloat16",
        }

    def _update_options_dict(self, new_options: dict):
        for k, v in new_options.items():
            if k in self.options:
                setattr(self, k, v)
            else:
                raise ValueError(f"Tried to set unexpected option {k}")

    def __getattr__(self, name: str):
        if "options" in self.__dict__ and name in self.options:
            return self.options[name]
        raise AttributeError(name)

    def __setattr__(self, name: str, value: Any):
        if "options" not in self.__dict__ or name not in self.options:
            super().__setattr__(name, value)
            return
        if name == "cast_model_type":
            if self.opt_level == "O1" and value is not None:
                if value is not False and value != torch.float32:
                    warn_or_err("O1 inserts casts around ops, so the model "
                                "should not be cast. cast_model_type was "
                                f"{value}")
            self.options[name] = _coerce_dtype(value)
        elif name == "cast_model_outputs":
            self.options[name] = _coerce_dtype(value)
        elif name in ("patch_torch_functions", "keep_batchnorm_fp32",
                      "master_weights"):
            self.options[name] = _coerce_bool(name, value)
        elif name == "loss_scale":
            if value == "dynamic":
                self.options[name] = "dynamic"
            elif value is None:
                self.options[name] = None
            else:
                self.options[name] = float(value)
        elif name == "half_dtype":
            if isinstance(value, str):
                if value not in _HALF_DTYPES:
                    raise ValueError(f"half_dtype must be one of "
                                     f"{sorted(_HALF_DTYPES)}, got {value}")
                value = _HALF_DTYPES[value]
            if value not in (torch.float16, torch.bfloat16):
                raise ValueError(f"half_dtype must be fp16/bf16, got {value}")
            self.options[name] = ("float16" if value == torch.float16
                                  else "bfloat16")
        else:
            self.options[name] = value

    @property
    def half_torch_dtype(self) -> torch.dtype:
        return _HALF_DTYPES[self.options["half_dtype"]]

    def __repr__(self):
        return "\n".join(f"{k:24}: {v}" for k, v in self.options.items())


def _coerce_dtype(value):
    if value is None or value is False:
        return value
    if isinstance(value, str):
        table = {"torch.float16": torch.float16, "torch.float32": torch.float32,
                 "float16": torch.float16, "float32": torch.float32,
                 "bfloat16": torch.bfloat16, "fp16": torch.float16,
                 "fp32": torch.float32, "bf16": torch.bfloat16,
                 "half": "half"}
        if value in table:
            return table[value]
        raise ValueError(f"Unknown dtype string {value!r}")
    if not isinstance(value, torch.dtype):
        raise ValueError(f"expected a torch.dtype, got {value!r}")
    return value


def _coerce_bool(name, value):
    if isinstance(value, str):
        if value == "True":
            return True
        if value == "False":
            return False
        raise ValueError(f"{name} must be True/False/None, got {value!r}")
    return value


class OptLevel:
    brief = ""

    def __call__(self, properties: Properties) -> Properties:
        raise NotImplementedError


class O3(OptLevel):
    brief = "O3: Pure half precision (the 'speed of light' ceiling)."

    def __call__(self, properties):
        properties.enabled = True
        properties.opt_level = "O3"
        properties.cast_model_type = "half"
        properties.patch_torch_functions = False
        properties.keep_batchnorm_fp32 = False
        properties.master_weights = False
        properties.loss_scale = 1.0
        return properties


class O2(OptLevel):
    brief = "O2: half-precision model with fp32 master weights and batchnorm."

    def __call__(self, properties):
        properties.enabled = True
        properties.opt_level = "O2"
        properties.cast_model_type = "half"
        properties.patch_torch_functions = False
        properties.keep_batchnorm_fp32 = True
        properties.master_weights = True
        properties.loss_scale = "dynamic"
        return properties


class O1(OptLevel):
    brief = "O1: insert casts at op boundaries per whitelist/blacklist."

    def __call__(self, properties):
        properties.enabled = True
        properties.opt_level = "O1"
        properties.cast_model_type = None
        properties.patch_torch_functions = True
        properties.keep_batchnorm_fp32 = None
        properties.master_weights = None
        properties.loss_scale = "dynamic"
        return properties


class O0(OptLevel):
    brief = "O0: pure fp32 (accuracy baseline)."

    def __call__(self, properties):
        properties.enabled = True
        properties.opt_level = "O0"
        properties.cast_model_type = torch.float32
        properties.patch_torch_functions = False
        properties.keep_batchnorm_fp32 = None
        properties.master_weights = False
        properties.loss_scale = 1.0
        return properties


opt_levels = {"O3": O3(), "O2": O2(), "O1": O1(), "O0": O0()}


def initialize(model, optimizers=None, enabled: bool = True,
               opt_level: str = "O1", cast_model_type=None,
               patch_torch_functions=None, keep_batchnorm_fp32=None,
               master_weights=None, loss_scale=None,
               cast_model_outputs=None, num_losses: int = 1,
               verbosity: int = 1, min_loss_scale=None,
               max_loss_scale=2. ** 24, half_dtype=None,
               hard_override: bool = False):
    """Three-line amp enablement, with the reference Apex's shape::

        model, optimizer = amp.initialize(model, FusedAdam(lr=1e-3),
                                          opt_level="O2")

    ``model`` is a ``torch.nn.Module``: its parameters are cast in place
    (BatchNorm kept fp32 when ``keep_batchnorm_fp32``) and its forward
    patched to cast inputs and outputs.  ``optimizers`` is a port
    optimizer (``optimizers.FusedAdam``); it comes back wrapped in an
    ``AmpOptimizer`` bound to the model's parameters.
    """
    from ._initialize import _initialize

    _amp_state.hard_override = hard_override
    _amp_state.verbosity = verbosity

    if not enabled:
        props = Properties()
        if half_dtype is not None:
            props.half_dtype = half_dtype
        return _initialize(model, optimizers, props, disabled=True)

    if opt_level not in opt_levels:
        raise RuntimeError(
            f"Unexpected optimization level {opt_level}. Options are 'O0', "
            "'O1', 'O2', 'O3'. Note that in `O0`, `O1`, etc., the prefix O "
            "is the letter O, not the number zero.")
    if opt_level == "O1":
        raise NotImplementedError(
            "opt_level='O1' needs the op-boundary cast policy "
            "(amp/policy.py, amp/lists.py), which apex_tpu_torch has not "
            "ported yet; use O0, O2 or O3")

    props = Properties()
    if half_dtype is not None:
        props.half_dtype = half_dtype
    props = opt_levels[opt_level](props)
    maybe_print(f"Selected optimization level {opt_level}: "
                f"{opt_levels[opt_level].brief}", True)

    overrides = dict(cast_model_type=cast_model_type,
                     patch_torch_functions=patch_torch_functions,
                     keep_batchnorm_fp32=keep_batchnorm_fp32,
                     master_weights=master_weights, loss_scale=loss_scale,
                     cast_model_outputs=cast_model_outputs,
                     num_losses=num_losses, min_loss_scale=min_loss_scale,
                     max_loss_scale=max_loss_scale)
    for k, v in overrides.items():
        if v is not None:
            setattr(props, k, v)
    if props.options["cast_model_type"] == "half":
        props.options["cast_model_type"] = props.half_torch_dtype
    if props.options["cast_model_outputs"] == "half":
        props.options["cast_model_outputs"] = props.half_torch_dtype
    # bf16 never needs dynamic scaling unless the user insists
    if (loss_scale is None and props.options["loss_scale"] == "dynamic"
            and props.half_torch_dtype == torch.bfloat16):
        props.options["loss_scale"] = 1.0
    maybe_print("After processing overrides, optimization options are:", True)
    for k, v in props.options.items():
        maybe_print(f"{k:24}: {v}", True)

    _amp_state.opt_properties = props
    return _initialize(model, optimizers, props)
