"""The port's sharded checkpoint (``apex_tpu_torch.utils.checkpoint_orbax``,
on ``torch.distributed.checkpoint``) against the JAX package's
``apex_tpu.utils.checkpoint_orbax`` (on Orbax), on the CPU: the cases of
tests/test_checkpoint.py::TestOrbaxSharded but its telemetry (the round
trip, async then wait, a second save joining the pending one, keep
pruning at return and at the join) and the durability cases of
TestChecksumDurability (a torn write, a never-joined save, a tampered
sidecar, the data state, a cross-dtype restore), each run through both
packages on the same tree, with the sidecar's crc32 equal to the JAX
package's for the same tree.  Then the reshard on read on 4 gloo ranks
(``tests/torch_dist_worker.py`` suite ``dcp``): a ZeRO-1 state saved as
``Shard(0)`` DTensors over 4 ranks (windows of 7 of 26 elements, the last
padded), read back into a ZeRO-2 layout (a (2, 2) mesh, ``Replicate`` x
``Shard(0)``, windows of 13) and into one process's whole tensors, all
bitwise.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import torch_dist_worker
from apex_tpu.utils import checkpoint_orbax as jco

from apex_tpu_torch.utils import checkpoint_orbax as co

pytest.importorskip("orbax.checkpoint")

SIDE = "_apex_checksum.json"


def _arrays(seed=0):
    rs = np.random.RandomState(seed)
    return {"w": rs.randn(8, 4).astype(np.float32),
            "b": rs.randn(4).astype(np.float32),
            "step": np.int32(7), "nested": [np.arange(3, dtype=np.int32),
                                             np.float32(3.5)]}


def _port_tree(a):
    return {"w": torch.from_numpy(a["w"].copy()),
            "b": torch.from_numpy(a["b"].copy()),
            "step": torch.tensor(int(a["step"]), dtype=torch.int32),
            "nested": [torch.from_numpy(a["nested"][0].copy()),
                       torch.tensor(float(a["nested"][1]))]}


def _jax_tree(a):
    mesh = Mesh(np.array(jax.devices()[:4]), ("model",))
    return {"w": jax.device_put(jnp.asarray(a["w"]),
                                NamedSharding(mesh, P("model", None))),
            "b": jnp.asarray(a["b"]), "step": jnp.asarray(a["step"]),
            "nested": [jnp.asarray(a["nested"][0]),
                       jnp.asarray(a["nested"][1])]}


def _zeros(tree):
    return jax.tree_util.tree_map(torch.zeros_like, tree)


def _crc(path):
    with open(os.path.join(path, SIDE)) as f:
        return json.load(f)["crc32"]


def _equal(a, b):
    for x, y in zip(jax.tree_util.tree_leaves(a),
                    jax.tree_util.tree_leaves(b)):
        assert torch.equal(x, y)


@pytest.fixture
def dirs(tmp_path):
    return str(tmp_path / "port"), str(tmp_path / "jax")


def test_roundtrip_and_the_jax_crc(dirs):
    port, jdir = dirs
    a = _arrays()
    tree = _port_tree(a)
    path = co.save_checkpoint(port, 5, tree)
    jpath = jco.save_checkpoint(jdir, 5, _jax_tree(a))
    assert co.available_steps(port) == jco.available_steps(jdir) == [5]
    assert _crc(path) == _crc(jpath)
    tmpl = _zeros(tree)
    back = co.restore_checkpoint(port, tmpl)
    assert back["w"] is tmpl["w"]            # loaded in place
    _equal(back, tree)
    assert co.latest_step(port) == 5
    # with a data state, chained into the crc as the JAX package chains it
    ds = {"seed": 1, "epoch": 2, "cursor": 48}
    assert _crc(co.save_checkpoint(port, 6, tree, data_state=ds)) == \
        _crc(jco.save_checkpoint(jdir, 6, _jax_tree(a), data_state=ds))


def test_async_save_then_wait(dirs):
    port, jdir = dirs
    a = _arrays(1)
    tree = _port_tree(a)
    path = co.save_checkpoint(port, 1, tree, async_save=True)
    co.wait()
    jpath = jco.save_checkpoint(jdir, 1, _jax_tree(a), async_save=True)
    jco.wait()
    assert os.path.exists(os.path.join(path, SIDE))
    assert _crc(path) == _crc(jpath)
    _equal(co.restore_checkpoint(port, _zeros(tree), step=1), tree)


def test_second_save_joins_pending(dirs):
    port, _ = dirs
    tree = _port_tree(_arrays())
    co.save_checkpoint(port, 1, tree, async_save=True)
    co.save_checkpoint(port, 2, _port_tree(_arrays(2)))   # joins step 1
    assert co.available_steps(port) == [1, 2]
    assert not os.path.exists(os.path.join(port,
                                           "_apex_pending_step_1.json"))
    _equal(co.restore_checkpoint(port, _zeros(tree), step=1), tree)


def test_keep_prunes(dirs):
    port, jdir = dirs
    a = _arrays()
    for s in (1, 2, 3, 4):
        co.save_checkpoint(port, s, _port_tree(a), keep=2)
        jco.save_checkpoint(jdir, s, _jax_tree(a), keep=2)
    assert co.available_steps(port) == jco.available_steps(jdir) == [3, 4]
    with pytest.raises(ValueError, match="keep"):
        co.save_checkpoint(port, 5, _port_tree(a), keep=0)


def test_async_keep_prunes_at_join(dirs):
    port, _ = dirs
    tree = _port_tree(_arrays())
    for s in (1, 2, 3):
        co.save_checkpoint(port, s, tree)
    co.save_checkpoint(port, 4, tree, async_save=True, keep=2)
    assert co.available_steps(port) == [1, 2, 3, 4]     # not yet durable
    co.wait()
    assert co.available_steps(port) == [3, 4]


def test_torn_and_altered_snapshots(dirs):
    port, jdir = dirs
    tree = _port_tree(_arrays())
    path = co.save_checkpoint(port, 5, tree)
    # a save that never joined: the sidecar gone, the marker back
    os.unlink(os.path.join(path, SIDE))
    marker = os.path.join(port, "_apex_pending_step_5.json")
    with open(marker, "w") as f:
        f.write('{"step": 5}')
    with pytest.raises(co.CheckpointCorrupt, match="never joined"):
        co.restore_checkpoint(port, _zeros(tree), step=5)
    # neither file: a legacy snapshot, trusted
    os.unlink(marker)
    _equal(co.restore_checkpoint(port, _zeros(tree), step=5), tree)
    # a tampered crc
    path = co.save_checkpoint(port, 6, tree)
    meta = json.load(open(os.path.join(path, SIDE)))
    meta["crc32"] = (meta["crc32"] + 1) & 0xFFFFFFFF
    json.dump(meta, open(os.path.join(path, SIDE), "w"))
    with pytest.raises(co.CheckpointCorrupt, match="mismatch"):
        co.restore_checkpoint(port, _zeros(tree), step=6)
    # a torn step directory: the shards gone
    path = co.save_checkpoint(port, 7, tree)
    for name in os.listdir(path):
        if name.endswith(".distcp"):
            os.unlink(os.path.join(path, name))
    with pytest.raises(co.CheckpointCorrupt):
        co.restore_checkpoint(port, _zeros(tree), step=7)
    jpath = jco.save_checkpoint(jdir, 7, _jax_tree(_arrays()))
    for name in os.listdir(jpath):
        if os.path.isdir(os.path.join(jpath, name)):
            shutil.rmtree(os.path.join(jpath, name))
    with pytest.raises(jco.CheckpointCorrupt):
        jco.restore_checkpoint(jdir, _jax_tree(_arrays()), step=7)
    with pytest.raises(FileNotFoundError):
        co.restore_checkpoint(str(dirs[0]) + "-none", tree)


def test_data_state_verified(dirs):
    port, jdir = dirs
    tree = _port_tree(_arrays())
    ds = {"seed": 1, "epoch": 2, "cursor": 48, "samples_consumed": 240}
    path = co.save_checkpoint(port, 1, tree, data_state=ds)
    jco.save_checkpoint(jdir, 1, _jax_tree(_arrays()), data_state=ds)
    assert co.load_data_state(port, step=1) == \
        jco.load_data_state(jdir, step=1) == ds
    assert co.load_data_state(port) == ds
    co.restore_checkpoint(port, _zeros(tree), step=1)    # verifies
    side = os.path.join(path, SIDE)
    meta = json.load(open(side))
    meta["data_state"]["cursor"] = 999
    json.dump(meta, open(side, "w"))
    with pytest.raises(co.CheckpointCorrupt):
        co.restore_checkpoint(port, _zeros(tree), step=1)
    with pytest.raises(co.CheckpointCorrupt):
        co.load_data_state(port, step=1)
    co.save_checkpoint(port, 2, tree)
    assert co.load_data_state(port, step=2) is None


def test_cross_dtype_restore_not_flagged(dirs):
    """bfloat16 saved, read into fp32 (a cast the contract allows) and
    back into bfloat16: both verify, the values exact."""
    port, _ = dirs
    tree = {"w": torch.arange(8).to(torch.bfloat16)}
    co.save_checkpoint(port, 1, tree)
    back = co.restore_checkpoint(port, {"w": torch.zeros(8)}, step=1)
    assert back["w"].dtype == torch.float32
    assert torch.equal(back["w"], torch.arange(8, dtype=torch.float32))
    back = co.restore_checkpoint(port, {"w": torch.zeros(
        8, dtype=torch.bfloat16)}, step=1)
    assert torch.equal(back["w"], tree["w"])


def test_numpy_and_number_leaves(dirs):
    port, _ = dirs
    tree = {"a": np.arange(4, dtype=np.float32), "n": 3, "x": 2.5}
    co.save_checkpoint(port, 1, tree)
    back = co.restore_checkpoint(port, {"a": np.zeros(4, np.float32),
                                        "n": 0, "x": 0.0})
    assert back["n"] == 3 and back["x"] == 2.5
    np.testing.assert_array_equal(back["a"], tree["a"])


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dcp")
    x = np.random.RandomState(0).randn(8, 5).astype(np.float32)
    out = torch_dist_worker.run("dcp", {"dir": str(tmp / "ck"), "x": x},
                                tmp, world=4)
    return out, str(tmp / "ck")


def test_reshard_on_read_on_four_ranks(gloo):
    out, _ = gloo
    saved = out[0]["saved"]
    assert out[0]["window"] == 7 and saved["step"] == 2
    for r in out:
        for k in ("masters", "m", "v"):
            np.testing.assert_array_equal(r["resharded"][k], saved[k])
        assert r["resharded"]["step"] == 2
        assert r["params2"].keys() == r["params"].keys()
        for n in r["params"]:
            np.testing.assert_array_equal(r["params2"][n], r["params"][n])
        assert r["data_state"] == {"cursor": 3}


def test_sharded_checkpoint_read_by_one_process(gloo):
    out, ck = gloo
    saved = out[0]["saved"]
    n = saved["masters"].shape[0]
    tmpl = {"scalers": [{"loss_scale": torch.zeros(()),
                         "unskipped": torch.zeros((), dtype=torch.int32),
                         "steps_skipped": torch.zeros((),
                                                      dtype=torch.int32)}],
            "inner": {"step": torch.zeros((), dtype=torch.int32),
                      "m": torch.zeros(n), "v": torch.zeros(n)},
            "masters": torch.zeros(n)}
    back = co.restore_checkpoint(ck, tmpl, step=1)     # verifies the crc
    np.testing.assert_array_equal(back["masters"].numpy(), saved["masters"])
    np.testing.assert_array_equal(back["inner"]["m"].numpy(), saved["m"])
    np.testing.assert_array_equal(back["inner"]["v"].numpy(), saved["v"])
    assert int(back["inner"]["step"]) == saved["step"]
    assert float(back["scalers"][0]["loss_scale"]) == saved["loss_scale"]
