"""Flash attention's plain versions and the attention dispatch against the
JAX package, on the CPU.

The JAX side runs its Pallas kernels in interpret mode
(``APEX_TPU_FORCE_PALLAS=1``), the port its wrappers' plain PyTorch
versions (CPU tensors); the same numpy inputs, masks and seed words go
through both.  At these lengths the JAX kernel is one (q, k) block, so the
two compute the same sums in other orders: fp32 results agree to a few
units of fp32 rounding.  In bf16, P (and dS) round to bf16 on both sides
from fp32 values that may differ in their last bits, so a value can land
on the neighbouring bf16 number: 2**-8 relative on a term.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu.ops import pallas_flash_attention as pfa
from apex_tpu.transformer import attention as jattn

from apex_tpu_torch import ops, transformer
from apex_tpu_torch.ops import flash_attention as fa
from apex_tpu_torch.utils.jax_interop import _to_numpy, _to_torch

B, H, D = 2, 2, 16
SEED = np.array([20231, -97531], np.int32)


def _np32(a) -> np.ndarray:
    return np.asarray(a).astype(np.float32)


def test_keep_unit_is_bitwise_the_jax_hash():
    """Every int32 corner of the seed words and large positions, on a
    (bh, q, k) grid: the uniforms agree bit for bit."""
    bh = np.array([0, 1, 7, 12345, 2 ** 31 - 1], np.int32)[:, None, None]
    q = np.array([0, 1, 127, 128, 511, 4097, 65535], np.int32)[None, :, None]
    k = np.arange(0, 600, 7, dtype=np.int32)[None, None, :]
    for s0, s1 in ((0, 0), (1, -1), (-2 ** 31, 2 ** 31 - 1),
                   (20231, -97531), (0x5555AAAA, -123456789)):
        want = np.asarray(pfa._keep_unit(jnp.int32(s0), jnp.int32(s1),
                                         jnp.asarray(bh), jnp.asarray(q),
                                         jnp.asarray(k)))
        got = fa.keep_unit(torch.tensor(s0, dtype=torch.int32),
                           torch.tensor(s1, dtype=torch.int32),
                           torch.from_numpy(bh), torch.from_numpy(q),
                           torch.from_numpy(k)).numpy()
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
        assert 0.0 <= got.min() and got.max() < 1.0


def _inputs(T, seed=0):
    rs = np.random.RandomState(seed + T)
    q, k, v, do = (rs.randn(B, H, T, D).astype(np.float32) for _ in range(4))
    kv_mask = rs.rand(B, T) > 0.3
    kv_mask[1] = False                # a sequence with no valid key: zeros
    # packed sequences: sorted ids, so each segment is one run
    segs = np.sort(rs.randint(0, 3, (B, T)), axis=1).astype(np.int32)
    return q, k, v, do, kv_mask, segs


VARIANTS = {
    "none": dict(),
    "causal": dict(causal=True),
    "kv_mask": dict(kv_mask=True),
    "segments": dict(segment_ids=True),
    "dropout": dict(dropout_rate=0.2),
    "all": dict(causal=True, kv_mask=True, segment_ids=True,
                dropout_rate=0.1),
}


# fp32 everywhere, bf16 where P, dS and the outputs round to bf16; T = 40
# is one 128-lane block on the TPU side, T = 200 not a multiple of the
# CUDA kernels' 64-row tiles
@pytest.mark.parametrize("variant,T,dtype", [
    ("none", 40, "fp32"), ("causal", 40, "fp32"), ("kv_mask", 40, "fp32"),
    ("segments", 40, "fp32"), ("dropout", 40, "fp32"), ("all", 200, "fp32"),
    ("none", 200, "bf16"), ("kv_mask", 40, "bf16"), ("dropout", 40, "bf16"),
])
def test_flash_attention_matches_jax(monkeypatch, variant, T, dtype):
    monkeypatch.setenv("APEX_TPU_FORCE_PALLAS", "1")
    v_ = VARIANTS[variant]
    q, k, v, do, kv_mask, segs = _inputs(T)
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    kw_j = dict(causal=v_.get("causal", False),
                dropout_rate=v_.get("dropout_rate", 0.0))
    kw_t = dict(kw_j)
    if v_.get("kv_mask"):
        kw_j["kv_mask"], kw_t["kv_mask"] = (jnp.asarray(kv_mask),
                                            torch.from_numpy(kv_mask))
    if v_.get("segment_ids"):
        kw_j["segment_ids"], kw_t["segment_ids"] = (jnp.asarray(segs),
                                                    torch.from_numpy(segs))
    if kw_j["dropout_rate"]:
        kw_j["dropout_seed"] = jnp.asarray(SEED)
        kw_t["dropout_seed"] = torch.from_numpy(SEED)
    jargs = [jnp.asarray(a, jd) for a in (q, k, v)]
    jo, vjp = jax.vjp(lambda *a: pfa.flash_attention(*a, **kw_j), *jargs)
    jgrads = vjp(jnp.asarray(do, jd))

    targs = [_to_torch(np.asarray(a)).requires_grad_() for a in jargs]
    to = fa.flash_attention(*targs, **kw_t)
    to.backward(_to_torch(np.asarray(jnp.asarray(do, jd))))
    if dtype == "fp32":
        tol = dict(rtol=1e-5, atol=1e-5)
    else:
        tol = dict(rtol=2 ** -7, atol=2 ** -6)
    np.testing.assert_allclose(_np32(_to_numpy(to.detach())), _np32(jo),
                               **tol)
    for t, j in zip(targs, jgrads):
        np.testing.assert_allclose(_np32(_to_numpy(t.grad)), _np32(j), **tol)
    if v_.get("kv_mask"):
        assert not to[1].detach().float().abs().max()   # no valid key


def test_flash_one_word_seed_gets_the_derived_second_word():
    q, k, v, _, _, _ = _inputs(24)
    args = [torch.from_numpy(a) for a in (q, k, v)]
    one = fa.flash_attention(*args, dropout_rate=0.3, dropout_seed=77)
    words = torch.tensor([77, 77 ^ 0x5555AAAA], dtype=torch.int32)
    two = fa.flash_attention(*args, dropout_rate=0.3, dropout_seed=words)
    assert torch.equal(one, two)
    jo = pfa.flash_attention(*[jnp.asarray(a) for a in (q, k, v)],
                             dropout_rate=0.3, dropout_seed=jnp.int32(77))
    np.testing.assert_allclose(one.numpy(), np.asarray(jo), rtol=1e-5,
                               atol=1e-5)


def test_flash_wrappers_check_their_operands():
    q = torch.ones(2, 8, 4)
    with pytest.raises(ValueError):
        ops.flash_fwd(q, q, q[:, :4], 1, 0.5)
    with pytest.raises(ValueError):
        ops.flash_fwd(q, q, q, 3, 0.5)                  # BH % H
    with pytest.raises(ValueError):
        ops.flash_fwd(q, q, q, 1, 0.5, rate=0.1)        # no seed
    with pytest.raises(ValueError):
        ops.flash_fwd(torch.ones(2, 8, 129), torch.ones(2, 8, 129),
                      torch.ones(2, 8, 129), 1, 0.5)    # D > 128
    with pytest.raises(ValueError):
        fa.flash_attention(*(torch.ones(1, 2, 8, 4),) * 3, dropout_rate=1.0)


# -- the dispatch -------------------------------------------------------------

@pytest.mark.parametrize("mask_kind,path", [
    (None, "flash"), ("key_padding", "flash"), ("pairs", "dense")])
def test_dispatch_matches_jax(monkeypatch, mask_kind, path):
    """dot_product_attention takes the flash route for no mask and key
    padding, the dense route for a per-pair mask, and matches JAX's."""
    monkeypatch.setenv("APEX_TPU_FORCE_PALLAS", "1")
    q, k, v, _, kv_mask, _ = _inputs(32)
    kv_mask[1] = True
    mask = None
    if mask_kind == "key_padding":
        mask = kv_mask[:, None, None, :]
    elif mask_kind == "pairs":
        mask = np.random.RandomState(1).rand(B, 1, 32, 32) > 0.2
    seen = {"jax": [], "port": []}
    jattn.set_path_hook(seen["jax"].append)
    transformer.set_path_hook(seen["port"].append)
    try:
        jo = jattn.dot_product_attention(
            *[jnp.asarray(a) for a in (q, k, v)],
            None if mask is None else jnp.asarray(mask))
        to = transformer.dot_product_attention(
            *[torch.from_numpy(a) for a in (q, k, v)],
            None if mask is None else torch.from_numpy(mask))
    finally:
        jattn.set_path_hook(None)
        transformer.set_path_hook(None)
    assert seen == {"jax": [path], "port": [path]}
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("variant", ["none", "key_padding", "causal",
                                     "segments"])
def test_head_dim_above_128_takes_the_dense_route(variant):
    """Head dim 160 is past the flash kernels' limit: the port takes the
    dense route, as the JAX package does on the CPU, and returns its
    result."""
    rs = np.random.RandomState(160)
    T, Dw = 12, 160
    q, k, v = (rs.randn(B, H, T, Dw).astype(np.float32) for _ in range(3))
    mask = segs = None
    if variant == "key_padding":
        mask = (rs.rand(B, T) > 0.3)[:, None, None, :]
    if variant == "segments":
        segs = np.sort(rs.randint(0, 3, (B, T)), axis=1).astype(np.int32)
    kw = dict(causal=variant == "causal")
    seen = []
    transformer.set_path_hook(seen.append)
    try:
        jo = jattn.dot_product_attention(
            *[jnp.asarray(a) for a in (q, k, v)],
            None if mask is None else jnp.asarray(mask),
            segment_ids=None if segs is None else jnp.asarray(segs), **kw)
        to = transformer.dot_product_attention(
            *[torch.from_numpy(a) for a in (q, k, v)],
            None if mask is None else torch.from_numpy(mask),
            segment_ids=None if segs is None else torch.from_numpy(segs),
            **kw)
    finally:
        transformer.set_path_hook(None)
    assert seen == ["dense"]
    assert to.shape == (B, H, T, Dw)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-5,
                               atol=1e-5)


def test_dropout_runs_only_with_a_generator():
    q, k, v, _, _, _ = _inputs(16)
    args = [torch.from_numpy(a) for a in (q, k, v)]
    plain = transformer.dot_product_attention(*args, dropout_rate=0.5)
    assert torch.equal(plain, transformer.dot_product_attention(*args))
    gen = torch.Generator().manual_seed(3)
    dropped = transformer.dot_product_attention(*args, dropout_rate=0.5,
                                                generator=gen)
    assert not torch.equal(plain, dropped)


def test_multihead_attention_matches_jax(monkeypatch):
    monkeypatch.setenv("APEX_TPU_FORCE_PALLAS", "1")
    from apex_tpu import nn as jnn
    from apex_tpu_torch.utils.jax_interop import params_from_jax
    E, T = 32, 12
    jm = jattn.MultiheadAttention(E, 4)
    params, _ = jm.init(jax.random.PRNGKey(0))
    rs = np.random.RandomState(2)
    x = rs.randn(B, T, E).astype(np.float32)
    kpm = np.zeros((B, T), bool)
    kpm[0, -3:] = True                      # ignore the last 3 keys of row 0
    jo, _ = jnn.apply(jm, params, jnp.asarray(x),
                      key_padding_mask=jnp.asarray(kpm))
    tm = transformer.MultiheadAttention(E, 4, device="cpu",
                                        generator=torch.Generator())
    tm.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                              params)),
                       strict=True)
    to = tm(torch.from_numpy(x), key_padding_mask=torch.from_numpy(kpm))
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo),
                               rtol=1e-5, atol=1e-5)
