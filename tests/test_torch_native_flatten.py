"""The port's host flatten helpers (``apex_tpu_torch._native.flatten``,
``unflatten``, ``plan_buckets``), built by g++ from
``_native/apex_tpu_torch_C.cpp``, against the JAX package's
``apex_tpu._native`` ones and their numpy fallbacks, bitwise; the dtype
refusal; and the ``multi_tensor_applier`` shim, which calls the op once
with the lists unpacked."""

import numpy as np
import pytest
import torch

from apex_tpu import _native as jnative

from apex_tpu_torch import _native
from apex_tpu_torch import multi_tensor_apply as mta

DTYPES = [np.float32, np.float16, np.int64, np.uint8]


def _arrays(dtype, seed=0):
    rs = np.random.RandomState(seed)
    shapes = [(3, 5), (7,), (0,), (2, 2, 2), (1,)]
    return [(rs.randn(*s) * 100).astype(dtype) for s in shapes]


@pytest.fixture(params=["library", "numpy"])
def route(request, monkeypatch):
    if request.param == "numpy":
        monkeypatch.setattr(_native, "library", lambda: None)
    else:
        assert _native.available(), _native.error()
    return request.param


@pytest.mark.parametrize("dtype", DTYPES)
def test_flatten_unflatten_roundtrip(route, dtype):
    arrays = _arrays(dtype)
    flat = _native.flatten(arrays)
    want = jnative.flatten(arrays)
    assert flat.dtype == want.dtype and flat.shape == want.shape
    assert flat.tobytes() == want.tobytes()
    back = _native.unflatten(flat, arrays)
    jback = jnative.unflatten(want, arrays)
    for a, b, c in zip(back, jback, arrays):
        assert a.shape == c.shape and a.tobytes() == b.tobytes() == \
            c.tobytes()
    assert _native.flatten([]).shape == (0,)


def test_flatten_dtype_mismatch(route):
    with pytest.raises(TypeError, match="same-dtype"):
        _native.flatten([np.zeros(2, np.float32), np.zeros(2, np.float16)])


@pytest.mark.parametrize("sizes,message", [
    ([10, 10, 10, 10, 10], 25), ([100], 10), ([], 10), ([1, 2, 3], 100),
    ([5, 30, 1, 1, 40, 2], 30)])
def test_plan_buckets_greedy(route, sizes, message):
    ids = _native.plan_buckets(sizes, message)
    want = jnative.plan_buckets(sizes, message)
    assert ids.dtype == np.int32 and ids.tolist() == want.tolist()


def test_multi_tensor_applier_calls_the_op_once():
    calls = []

    def op(x, y, scale):
        calls.append((x, y, scale))
        return mta.multi_tensor_axpby(scale, 1.0, x, y)

    x, y = [torch.ones(3), torch.ones(2)], [torch.zeros(3), torch.ones(2)]
    out, found = mta.multi_tensor_applier(op, [x, y], 2.0)
    assert len(calls) == 1 and float(found) == 0.0
    assert torch.equal(out[1], torch.full((2,), 3.0))
    assert mta.multi_tensor_applier.chunk_size == 2048 * 32
    assert mta.MultiTensorApply(1024).available
