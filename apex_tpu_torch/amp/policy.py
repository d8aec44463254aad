"""The dtype-cast policy consulted by ``apex_tpu_torch.nn.functional``.

Counterpart of ``apex_tpu/amp/policy.py``.  The reference Apex implements
O1 by monkey-patching ~200 torch entry points with cast wrappers
(apex/amp/amp.py:68-177, wrap.py:73-216).  The port, like the JAX
package, patches nothing: the policy lives in a context that the port's
own functional ops consult at each call.

Policies:

- ``NoPolicy``      — O0/O2/O3: ops execute in their inputs' dtypes (for
  O2/O3 the *parameters* were cast instead, see _initialize.py).
- ``CastPolicy``    — O1: whitelist ops cast args to the half dtype,
  blacklist ops to fp32, promote ops to the widest floating dtype of their
  args; banned ops raise with the reference's actionable message
  (functional_overrides.py:68-78).

``set_policy`` installs the process-wide default (what ``amp.initialize``
does at O1); ``use_policy`` pushes one for the current thread until its
block ends; ``disable_casts()`` reproduces apex's escape hatch
(apex/amp/handle.py:162-166).  A cast is ``Tensor.to``, so autograd
carries each grad back to its tensor's own dtype: an fp32 weight cast to
bf16 for a matmul gets an fp32 grad.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Any, Callable, Optional, Sequence

import torch

from . import lists

__all__ = [
    "Policy", "NoPolicy", "CastPolicy", "current_policy", "set_policy",
    "use_policy", "disable_casts", "cast_op_args", "half_function",
    "float_function", "promote_function",
]

# fp16 and bf16 rank alike: the first one met wins, as in the JAX package
_RANK = {torch.float16: 1, torch.bfloat16: 1, torch.float32: 2,
         torch.float64: 3}


def _cast_tree(tree: Any, dtype: torch.dtype) -> Any:
    """``tree`` with every floating tensor cast to ``dtype``, walking
    tuples, lists and dicts; anything else (ints, bools, generators,
    Python scalars, None) passes through."""
    if isinstance(tree, torch.Tensor):
        if tree.is_floating_point() and tree.dtype != dtype:
            return tree.to(dtype)
        return tree
    if isinstance(tree, (tuple, list)):
        return type(tree)(_cast_tree(t, dtype) for t in tree)
    if isinstance(tree, dict):
        return {k: _cast_tree(v, dtype) for k, v in tree.items()}
    return tree


def _widest_dtype(args: Sequence[Any]) -> Optional[torch.dtype]:
    widest = None

    def visit(x):
        nonlocal widest
        if isinstance(x, torch.Tensor):
            if x.is_floating_point() and (
                    widest is None
                    or _RANK.get(x.dtype, 0) > _RANK.get(widest, 0)):
                widest = x.dtype
        elif isinstance(x, (tuple, list)):
            for t in x:
                visit(t)
        elif isinstance(x, dict):
            for t in x.values():
                visit(t)
    visit(list(args))
    return widest


class Policy:
    """Base: identity policy (no casting)."""

    enabled = False

    def cast_args(self, op_name: str, args: tuple, kwargs: dict):
        return args, kwargs


class NoPolicy(Policy):
    pass


class CastPolicy(Policy):
    """O1 whitelist/blacklist/promote casting, driven by amp.lists tables."""

    enabled = True

    def __init__(self, half_dtype: torch.dtype = torch.bfloat16):
        if half_dtype not in (torch.float16, torch.bfloat16):
            raise ValueError(f"half_dtype must be fp16/bf16, got "
                             f"{half_dtype}")
        self.half_dtype = half_dtype

    def cast_args(self, op_name: str, args: tuple, kwargs: dict):
        kind = lists.classify(op_name)
        if kind == "banned":
            raise NotImplementedError(lists.BANNED_MSG)
        if kind == "half":
            return (_cast_tree(args, self.half_dtype),
                    _cast_tree(kwargs, self.half_dtype))
        if kind == "float":
            return (_cast_tree(args, torch.float32),
                    _cast_tree(kwargs, torch.float32))
        if kind in ("promote", "sequence"):
            widest = _widest_dtype(list(args) + list(kwargs.values()))
            if widest is not None:
                return _cast_tree(args, widest), _cast_tree(kwargs, widest)
        return args, kwargs


_NO_POLICY = NoPolicy()
# slot 0 of every thread's stack: the process-wide default
_DEFAULT = [_NO_POLICY]


class _PolicyState(threading.local):
    def __init__(self):
        self.stack = []
        self.casts_disabled = 0


_STATE = _PolicyState()


def current_policy() -> Policy:
    s = _STATE
    if s.casts_disabled:
        return _NO_POLICY
    return s.stack[-1] if s.stack else _DEFAULT[0]


def set_policy(policy: Policy) -> None:
    """Install ``policy`` as the process-wide default (what amp.initialize
    does for O1 — mirrors the global effect of apex's monkey-patching).
    ``set_policy(NoPolicy())`` undoes it."""
    _DEFAULT[0] = policy


@contextlib.contextmanager
def use_policy(policy: Policy):
    """Run this thread's ops under ``policy`` until the block ends."""
    _STATE.stack.append(policy)
    try:
        yield policy
    finally:
        _STATE.stack.pop()


@contextlib.contextmanager
def disable_casts():
    """Temporarily run ops in their incoming dtypes (handle.py:162-166)."""
    _STATE.casts_disabled += 1
    try:
        yield
    finally:
        _STATE.casts_disabled -= 1


def cast_op_args(op_name: str, args: tuple, kwargs: dict):
    """Entry point used by apex_tpu_torch.nn.functional at every op
    dispatch: ``(args, kwargs)`` as the active policy casts them."""
    pol = current_policy()
    if not pol.enabled:
        return args, kwargs
    return pol.cast_args(op_name, args, kwargs)


def _wrap_with(cast: Callable, fn: Callable) -> Callable:
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        pol = current_policy()
        if not pol.enabled:
            return fn(*args, **kwargs)
        args, kwargs = cast(pol, args, kwargs)
        return fn(*args, **kwargs)
    return wrapper


def half_function(fn: Callable) -> Callable:
    """Decorator: run ``fn`` with float args cast to the policy half dtype
    (reference: apex/amp/amp.py:30-33)."""
    return _wrap_with(
        lambda p, a, k: (_cast_tree(a, p.half_dtype),
                         _cast_tree(k, p.half_dtype)), fn)


def float_function(fn: Callable) -> Callable:
    """Decorator: run ``fn`` with float args cast to fp32 (amp.py:35-38)."""
    return _wrap_with(
        lambda p, a, k: (_cast_tree(a, torch.float32),
                         _cast_tree(k, torch.float32)), fn)


def promote_function(fn: Callable) -> Callable:
    """Decorator: run ``fn`` with float args promoted to the widest incoming
    float dtype (amp.py:40-42)."""
    def cast(_p, a, k):
        widest = _widest_dtype(list(a) + list(k.values()))
        if widest is None:
            return a, k
        return _cast_tree(a, widest), _cast_tree(k, widest)
    return _wrap_with(cast, fn)
