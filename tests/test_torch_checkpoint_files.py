"""``apex_tpu_torch.utils.checkpoint`` against ``apex_tpu.utils.checkpoint``.

The port's specs of tests/test_checkpoint.py (save, restore, ``keep``,
``latest_step``, a template that does not match, the checksum against bit
rot and truncation, the durable-step fallback, snapshots older than the
checksum, the data-state blob), then the file format across packages: a
checkpoint the JAX package writes of ResNet-18's ``(params, bn_state)``
restores into the port's template and, mapped by ``utils.jax_interop``,
into the port's model bitwise, and the reverse.  Everything is compared
bitwise: a checkpoint moves bytes.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu import amp as jamp
from apex_tpu import models as jmodels
from apex_tpu import optimizers as joptim
from apex_tpu.utils import checkpoint as jckpt

from apex_tpu_torch import amp, models, nn, optimizers
from apex_tpu_torch.nn.functional import mse_loss
from apex_tpu_torch.utils import checkpoint as ckpt
from apex_tpu_torch.utils.jax_interop import params_from_jax, params_to_jax


def _train_state(seed=0):
    gen = torch.Generator().manual_seed(seed)
    net = torch.nn.Sequential(
        nn.Linear(4, 8, device="cpu", generator=gen), nn.ReLU(),
        nn.Linear(8, 2, device="cpu", generator=gen))
    return amp.initialize(net, optimizers.FusedAdam(lr=1e-2),
                          opt_level="O2", verbosity=0, hard_override=True)


def _step(model, opt, x, y):
    loss = mse_loss(model(x), y)
    with amp.scale_loss(loss, opt) as scaled:
        scaled.backward()
    opt.step()


def _tree(model, opt):
    return {"model": model.state_dict(), "optimizer": opt.state_dict(),
            "amp": amp.state_dict(opt), "step": 3}


def _same(a, b):
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    return a == b


def _walk(tree):
    return list(ckpt._leaves(tree))


def test_roundtrip_identity(tmp_path):
    model, opt = _train_state()
    tree = _tree(model, opt)
    assert model.state_dict()["0.weight"].dtype == torch.bfloat16
    path = ckpt.save_checkpoint(str(tmp_path), 3, tree)
    assert path.endswith("ckpt_00000003.npz")
    restored = ckpt.restore_checkpoint(str(tmp_path), tree)
    got, want = _walk(restored), _walk(tree)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (_, a), (_, b) in zip(got, want):
        assert _same(a, b)
    assert type(restored["step"]) is int


def test_resume_continues_identically(tmp_path):
    """Three steps, a checkpoint, two more; a fresh pair restored from it
    and stepped twice lands on the same bits."""
    rs = np.random.RandomState(1)
    x = torch.from_numpy(rs.randn(8, 4).astype(np.float32))
    y = torch.from_numpy(rs.randn(8, 2).astype(np.float32))
    model, opt = _train_state()
    for _ in range(3):
        _step(model, opt, x, y)
    ckpt.save_checkpoint(str(tmp_path), 3, {"model": model.state_dict(),
                                            "optimizer": opt.state_dict()})
    for _ in range(2):
        _step(model, opt, x, y)
    m2, o2 = _train_state(seed=5)
    r = ckpt.restore_checkpoint(str(tmp_path), {"model": m2.state_dict(),
                                                "optimizer": o2.state_dict()})
    m2.load_state_dict(r["model"])
    o2.load_state_dict(r["optimizer"])
    for _ in range(2):
        _step(m2, o2, x, y)
    for (k, a), (_, b) in zip(model.state_dict().items(),
                              m2.state_dict().items()):
        assert torch.equal(a, b), k
    assert torch.equal(opt.masters.buf, o2.masters.buf)


def test_retention_and_latest(tmp_path):
    tree = {"w": torch.zeros(2)}
    for s in (1, 2, 3, 4):
        ckpt.save_checkpoint(str(tmp_path), s, tree, keep=2)
    assert ckpt.available_steps(str(tmp_path)) == [3, 4]
    assert ckpt.latest_step(str(tmp_path)) == 4
    assert ckpt.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(ValueError, match="keep"):
        ckpt.save_checkpoint(str(tmp_path), 5, tree, keep=0)


def test_restore_specific_step(tmp_path):
    for s in (1, 2):
        ckpt.save_checkpoint(str(tmp_path), s, {"w": torch.full((2,), s)})
    r = ckpt.restore_checkpoint(str(tmp_path), {"w": torch.zeros(2)}, step=1)
    assert torch.equal(r["w"], torch.ones(2))


def test_template_mismatch_raises(tmp_path):
    ckpt.save_checkpoint(str(tmp_path), 1, {"w": torch.zeros(2)})
    with pytest.raises(KeyError):
        ckpt.restore_checkpoint(str(tmp_path), {"other": torch.zeros(2)})
    # the leaf is named: the example's conv7 -> s2d resume matches on it
    with pytest.raises(ValueError, match=r"\['w'\]"):
        ckpt.restore_checkpoint(str(tmp_path), {"w": torch.zeros(3)})
    with pytest.raises(FileNotFoundError):
        ckpt.restore_checkpoint(str(tmp_path / "none"), {"w": torch.zeros(2)})


def _checksummed(tmp_path):
    rs = np.random.RandomState(0)
    tree = {"w": torch.from_numpy(rs.randn(8, 4).astype(np.float32)),
            "b": torch.from_numpy(rs.randn(4).astype(np.float32)),
            "step": torch.tensor(7)}
    return tree


def test_verify_bit_rot_truncation_and_durable_fallback(tmp_path):
    tree = _checksummed(tmp_path)
    d = str(tmp_path)
    ckpt.save_checkpoint(d, 1, tree)
    path2 = ckpt.save_checkpoint(d, 2, tree)
    ckpt.verify_checkpoint(d, 1)
    assert ckpt.latest_durable_step(d) == 2
    # bytes flipped inside a stored array, the zip structure intact: only
    # the content checksum sees it
    data = bytearray(open(path2, "rb").read())
    off = len(data) // 2
    data[off:off + 4] = bytes(b ^ 0xFF for b in data[off:off + 4])
    open(path2, "wb").write(bytes(data))
    with pytest.raises(ckpt.CheckpointCorrupt):
        ckpt.restore_checkpoint(d, tree, step=2)
    assert ckpt.latest_durable_step(d) == 1
    # truncated
    path1 = ckpt.save_checkpoint(d, 3, tree)
    with open(path1, "rb+") as f:
        f.truncate(len(open(path1, "rb").read()) * 6 // 10)
    with pytest.raises(ckpt.CheckpointCorrupt):
        ckpt.verify_checkpoint(d, 3)
    assert ckpt.latest_durable_step(d) == 1
    restored = ckpt.restore_checkpoint(d, tree, step=1)
    assert torch.equal(restored["w"], tree["w"])


def test_snapshot_without_checksum_loads(tmp_path):
    tree = _checksummed(tmp_path)
    with open(tmp_path / "ckpt_00000001.npz", "wb") as f:
        np.savez(f, **{k: v.numpy() for k, v in ckpt._leaves(tree)})
    ckpt.verify_checkpoint(str(tmp_path), 1)
    r = ckpt.restore_checkpoint(str(tmp_path), tree, step=1)
    assert torch.equal(r["b"], tree["b"])


def test_data_state_round_trip_and_checksummed(tmp_path):
    d = str(tmp_path)
    state = {"seed": 3, "epoch": 1, "cursor": 64, "shuffle": True}
    ckpt.save_checkpoint(d, 1, {"w": torch.zeros(2)}, data_state=state)
    ckpt.save_checkpoint(d, 2, {"w": torch.zeros(2)})
    assert ckpt.load_data_state(d, step=1) == state
    assert ckpt.load_data_state(d) is None
    # the JAX package reads the same blob, and the snapshot's checksum
    # covers it
    assert jckpt.load_data_state(d, step=1) == state
    jckpt.verify_checkpoint(d, 1)
    r = ckpt.restore_checkpoint(d, {"w": torch.zeros(2)}, step=1)
    assert torch.equal(r["w"], torch.zeros(2))
    with pytest.raises(FileNotFoundError):
        ckpt.load_data_state(str(tmp_path / "none"))


def test_keypaths_are_jax_keystr():
    tree = {"b": (torch.zeros(1), [torch.ones(1), None, 3]),
            "a": {"x'y": 1.0, "q": np.int32(2)}}
    jtree = {"b": (np.zeros(1), [np.ones(1), None, 3]),
             "a": {"x'y": 1.0, "q": np.int32(2)}}
    want = [jax.tree_util.keystr(p) for p, _ in
            jax.tree_util.tree_flatten_with_path(jtree)[0]]
    assert [k for k, _ in ckpt._leaves(tree)] == want


# -- across the two packages --------------------------------------------------

@pytest.fixture(scope="module")
def jax_resnet18():
    """ResNet-18's ``(params, bn_state)`` under O2 (bf16 convs, fp32
    BatchNorm, int32 counters), with values from numpy: the tree and
    dtypes of ``init``, without computing it."""
    jmodel, _ = jamp.initialize(jmodels.resnet18(), joptim.FusedAdam(),
                                opt_level="O2", verbosity=0)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    rs = np.random.RandomState(0)
    params, state = jax.tree_util.tree_map(
        lambda l: jnp.asarray((rs.standard_normal(l.shape) * 10)
                              .astype(np.float32), l.dtype), shapes)
    return params, state


def _port_resnet18():
    port, _ = amp.initialize(models.resnet18(device="cpu"),
                             optimizers.FusedAdam(), opt_level="O2",
                             verbosity=0)
    return port


def test_jax_checkpoint_restores_into_the_port_bitwise(tmp_path,
                                                       jax_resnet18):
    params, state = jax_resnet18
    jckpt.save_checkpoint(str(tmp_path), 1, (params, state))
    port = _port_resnet18()
    template = params_to_jax(port.state_dict())
    restored = ckpt.restore_checkpoint(str(tmp_path), template)
    port.load_state_dict(params_from_jax(*restored))
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                           jax.tree_util.tree_map(np.asarray, state))
    got = port.state_dict()
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


def test_port_checkpoint_restores_into_jax_bitwise(tmp_path, jax_resnet18):
    params, state = jax_resnet18
    port = _port_resnet18()
    port.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params),
        jax.tree_util.tree_map(np.asarray, state)))
    ckpt.save_checkpoint(str(tmp_path), 1, params_to_jax(port.state_dict()),
                         data_state={"cursor": 5})
    template = jax.tree_util.tree_map(jnp.zeros_like, (params, state))
    jckpt.verify_checkpoint(str(tmp_path), 1)
    restored = jckpt.restore_checkpoint(str(tmp_path), template)
    for a, b in zip(jax.tree_util.tree_leaves(restored),
                    jax.tree_util.tree_leaves((params, state))):
        assert a.dtype == b.dtype
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
