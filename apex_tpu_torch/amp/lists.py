"""Op-classification tables for the O1 cast policy.

Counterpart of ``apex_tpu/amp/lists.py``, the same tables.  The reference
Apex keeps three monkey-patch lists: fp16 whitelist (gemms and
convolutions), fp32 blacklist (transcendentals, reductions, losses, norms)
and type-promote ops (apex/amp/lists/torch_overrides.py:7-61,83-105 and
functional_overrides.py:29-78).  Here, as in the JAX package, they are
*op categories* that ``apex_tpu_torch.nn.functional`` consults at
dispatch time: the port patches no torch entry point, so a cast happens
only where a call goes through the port's functional layer.

User extension mirrors apex.amp's registries (apex/amp/amp.py:30-64):
``register_half_function`` / ``register_float_function`` /
``register_promote_function`` move an op name between categories, and the
``@half_function`` / ``@float_function`` / ``@promote_function`` decorators
of ``amp.policy`` wrap arbitrary user callables with the corresponding
cast behavior.
"""

from __future__ import annotations

from typing import Set

# Ops that run fastest and safest in half precision on tensor cores: dense
# matmuls and convolutions (reference: torch_overrides.py:7-27).
FP16_FUNCS: Set[str] = {
    "conv1d", "conv2d", "conv3d",
    "conv_transpose1d", "conv_transpose2d", "conv_transpose3d",
    "conv_tbc",
    "linear", "matmul", "mm", "mv", "bmm",
    "addmm", "addmv", "addr", "addbmm", "baddbmm",
    "prelu",
    # attention inner matmuls route through matmul; kept explicit for clarity
    "dot_product_attention",
}

# Ops numerically fragile in fp16/bf16: transcendentals, norms, reductions,
# losses, softmax (reference: torch_overrides.py:29-61,
# functional_overrides.py:29-66).
FP32_FUNCS: Set[str] = {
    "acos", "asin", "cosh", "erfinv", "exp", "expm1", "log", "log10",
    "log2", "log1p", "reciprocal", "rsqrt", "sinh", "tan", "pow",
    "softplus", "gelu", "erf",
    "cumprod", "cumsum", "dist", "mean", "norm", "prod", "std", "sum",
    "var", "renorm", "logsumexp",
    "softmax", "log_softmax", "softmin",
    "layer_norm", "group_norm", "batch_norm", "instance_norm", "normalize",
    "cosine_similarity", "pdist",
    "cross_entropy", "nll_loss", "l1_loss", "mse_loss", "smooth_l1_loss",
    "kl_div", "multilabel_margin_loss", "soft_margin_loss",
    "binary_cross_entropy_with_logits", "poisson_nll_loss",
    "cosine_embedding_loss", "hinge_embedding_loss", "margin_ranking_loss",
    "triplet_margin_loss", "multi_margin_loss",
}

# Multi-arg ops whose float args must agree: promote to the widest type
# (reference: torch_overrides.py:83-105).
PROMOTE_FUNCS: Set[str] = {
    "add", "sub", "mul", "div", "addcdiv", "addcmul", "atan2",
    "cross", "bilinear", "dot", "equal", "eq", "ne", "lt", "gt", "le", "ge",
    "min", "max", "fmod", "remainder",
}

# Sequence ops: promote every element of the tensor-sequence argument
# (reference: torch_overrides.py:109-112).
SEQUENCE_PROMOTE_FUNCS: Set[str] = {"cat", "stack", "concatenate"}

# Banned in half precision with an actionable error (reference:
# functional_overrides.py:68-78 — binary_cross_entropy after a sigmoid
# under-/overflows in fp16; users must switch to the fused logits form).
BANNED_FUNCS: Set[str] = {"binary_cross_entropy"}

BANNED_MSG = (
    "amp does not work out-of-the-box with `binary_cross_entropy` on half "
    "inputs: a sigmoid followed by BCE is numerically unsafe in half "
    "precision. Use `binary_cross_entropy_with_logits` (it fuses the "
    "sigmoid in fp32), or wrap your call with "
    "apex_tpu_torch.amp.disable_casts() if you know what you're doing."
)


def classify(op_name: str) -> str:
    """Return one of 'half', 'float', 'promote', 'sequence', 'banned', 'none'."""
    if op_name in BANNED_FUNCS:
        return "banned"
    if op_name in FP16_FUNCS:
        return "half"
    if op_name in FP32_FUNCS:
        return "float"
    if op_name in PROMOTE_FUNCS:
        return "promote"
    if op_name in SEQUENCE_PROMOTE_FUNCS:
        return "sequence"
    return "none"


def _move(op_name: str, dest: Set[str]) -> None:
    for s in (FP16_FUNCS, FP32_FUNCS, PROMOTE_FUNCS, SEQUENCE_PROMOTE_FUNCS,
              BANNED_FUNCS):
        s.discard(op_name)
    dest.add(op_name)


def register_half_function(op_name: str) -> None:
    """Treat ``op_name`` as an fp16/bf16-whitelist op from now on."""
    _move(op_name, FP16_FUNCS)


def register_float_function(op_name: str) -> None:
    """Treat ``op_name`` as an fp32-blacklist op from now on."""
    _move(op_name, FP32_FUNCS)


def register_promote_function(op_name: str) -> None:
    """Treat ``op_name`` as a widest-type-promote op from now on."""
    _move(op_name, PROMOTE_FUNCS)
