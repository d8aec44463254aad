"""``apex_tpu_torch.data.DataLoader`` and ``_native`` against the JAX
package's, on the CPU.

- The Python pipeline (batches over two shuffled epochs, NCHW and NHWC,
  its ``state_dict`` resume, shards, the quarantine) bitwise the same as
  ``apex_tpu.data.DataLoader(native=False)``.  Both normalize through
  their native library when it loads, through numpy when not, and the two
  routes differ in the last bit (the library multiplies by 1/std), so these
  comparisons take both packages' numpy route: each library is switched
  off for the test with ``monkeypatch``.
- The native ring against the Python pipeline, and the native normalize
  against the JAX package's numpy route, within the tolerance of
  tests/test_data_loader.py (rtol 1e-6, atol 1e-5); labels and order
  exactly.
- The library's build under concurrency: several processes, started
  together on an empty build directory, each build and load it.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import apex_tpu._native as jnative
from apex_tpu.data import DataLoader as JLoader

import apex_tpu_torch._native as native
from apex_tpu_torch.data import DataLoader

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-6, atol=1e-5)


def _data(n=40, hw=6):
    rs = np.random.RandomState(0)
    return (rs.randint(0, 256, (n, hw, hw + 1, 3)).astype(np.uint8),
            rs.randint(0, 10, n).astype(np.int64))


@pytest.fixture
def numpy_route(monkeypatch):
    """Both packages normalize through numpy."""
    monkeypatch.setattr(native, "library", lambda: None)
    monkeypatch.setattr(jnative, "_try_load", lambda: None)


def _stream(loader, n):
    return [loader.next_batch() for _ in range(n)]


def _same_stream(a, b):
    assert len(a) == len(b)
    for (ia, la, ba), (ib, lb, bb) in zip(a, b):
        assert ba == bb
        np.testing.assert_array_equal(la, lb)
        assert ia.dtype == ib.dtype == np.float32 and ia.shape == ib.shape
        assert ia.tobytes() == ib.tobytes()


@pytest.mark.parametrize("data_format", ["NCHW", "NHWC"])
def test_python_pipeline_matches_jax_bitwise(numpy_route, data_format):
    images, labels = _data()
    kw = dict(batch_size=8, seed=3, data_format=data_format)
    port = DataLoader(images, labels, native=False, **kw)
    ref = JLoader(images, labels, native=False, **kw)
    assert not port.native and not ref.native
    _same_stream(_stream(port, 11), _stream(ref, 11))   # past 2 epochs
    assert port.stats()["samples_consumed"] == \
        ref.stats()["samples_consumed"] == 88
    assert port.stats()["epoch"] == ref.stats()["epoch"] == 2
    assert list(DataLoader(images, labels, native=False, **kw))[0][0].shape \
        == ((8, 3, 6, 7) if data_format == "NCHW" else (8, 6, 7, 3))


def test_state_dict_resume_matches_jax(numpy_route):
    images, labels = _data()
    kw = dict(batch_size=8, seed=5, native=False)
    port, ref = DataLoader(images, labels, **kw), JLoader(images, labels, **kw)
    _stream(port, 7)
    _stream(ref, 7)
    sd = port.state_dict()
    assert sd == ref.state_dict()
    json.dumps(sd)
    resumed, jresumed = (DataLoader(images, labels, **kw),
                         JLoader(images, labels, **kw))
    resumed.load_state_dict(sd)
    jresumed.load_state_dict(sd)
    want = _stream(port, 4)
    _same_stream(_stream(resumed, 4), want)
    _same_stream(_stream(jresumed, 4), want)
    for bad in (dict(sd, seed=6), dict(sd, n=41), dict(sd, cursor=99)):
        with pytest.raises(ValueError):
            DataLoader(images, labels, **kw).load_state_dict(bad)


def test_shards_match_jax(numpy_route):
    images, labels = _data()
    for shard in range(2):
        kw = dict(batch_size=4, seed=1, shard_id=shard, num_shards=2)
        port = DataLoader(images, labels, **kw)
        assert not port.native            # shards take the Python pipeline
        _same_stream(_stream(port, 12), _stream(JLoader(images, labels, **kw),
                                                12))
    with pytest.raises(ValueError, match="shard_id"):
        DataLoader(images, labels, batch_size=4, shard_id=2, num_shards=2)
    for mk in (DataLoader, JLoader):
        with pytest.raises(TypeError, match="uint8"):
            mk(images.astype(np.float32), labels, batch_size=4)


def test_quarantine_matches_jax(numpy_route):
    images, labels = _data()
    bad = {3, 7, 11, 12, 30}
    kw = dict(batch_size=8, seed=2, bad_record_fn=lambda i: i in bad)
    port, ref = DataLoader(images, labels, **kw), JLoader(images, labels, **kw)
    _same_stream(_stream(port, 5), _stream(ref, 5))
    assert port.stats()["samples_quarantined"] == \
        ref.stats()["samples_quarantined"] > 0
    with pytest.raises(RuntimeError, match="every record"):
        DataLoader(images, labels, batch_size=8,
                   bad_record_fn=lambda i: True).next_batch()


@pytest.mark.parametrize("data_format", ["NCHW", "NHWC"])
def test_native_ring_matches_python_pipeline(data_format):
    assert native.available(), native.error()
    images, labels = _data()
    kw = dict(batch_size=8, shuffle=False, data_format=data_format)
    ring = DataLoader(images, labels, native=True, **kw)
    py = DataLoader(images, labels, native=False, **kw)
    try:
        assert ring.native and ring.stats()["native"]
        for (ia, la, ba), (ib, lb, bb) in zip(_stream(ring, 7),
                                              _stream(py, 7)):
            assert ba == bb
            np.testing.assert_array_equal(la, lb)
            np.testing.assert_allclose(ia, ib, **TOL)
        assert ring.stats()["samples_consumed"] == 56
        with pytest.raises(RuntimeError, match="Python pipeline"):
            ring.state_dict()
    finally:
        ring.close()


def test_native_shuffle_covers_each_sample_once_an_epoch():
    images, labels = _data()
    labels = np.arange(len(images))
    ring = DataLoader(images, labels, batch_size=8, native=True, seed=4)
    try:
        seen = np.concatenate([b for _, b in ring])
        assert sorted(seen.tolist()) == list(range(40))
    finally:
        ring.close()


def test_zero_copy_view_lives_until_the_next_batch():
    images, labels = _data()
    kw = dict(batch_size=8, shuffle=False, native=True)
    ring = DataLoader(images, labels, zero_copy=True, **kw)
    ref = DataLoader(images, labels, **kw)
    try:
        imgs0, lbls0, _ = ring.next_batch()
        rimgs0, rlbls0, _ = ref.next_batch()
        np.testing.assert_array_equal(lbls0, rlbls0)
        np.testing.assert_array_equal(imgs0, rimgs0)
        assert not imgs0.flags.owndata
    finally:
        ring.close()
        ref.close()


def test_native_normalize_matches_jax(monkeypatch):
    """The port's library against the JAX package's numpy route (its
    library is built in place, which concurrent test workers must not
    race)."""
    assert native.available(), native.error()
    monkeypatch.setattr(jnative, "_try_load", lambda: None)
    images, _ = _data(n=5)
    mean, std = (120.0, 110.0, 100.0), (60.0, 58.0, 57.0)
    for fmt in ("NCHW", "NHWC"):
        got = native.preprocess_images(images, mean, std, fmt)
        want = jnative.preprocess_images(images, mean, std, fmt)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, **TOL)


def _metric_values(reg):
    """name -> (kind, value or histogram count) of a registry."""
    out = {}
    for m in reg.collect():
        val = m.summary()["count"] if hasattr(m, "summary") else m.value
        out[m.name] = (type(m).__name__, val)
    return out


def test_metrics_and_ring_match_jax(numpy_route):
    """The loader's ``metrics=`` and ``ring=`` against the JAX loader's on
    the same data and ``bad_record_fn``: ``stats()`` keys and counts, the
    registry's metrics, and the ring's ``data_sample_quarantined`` events
    field for field (the timestamps aside); and the registry of a loader
    resumed from the first one's ``state_dict()``."""
    from apex_tpu import observability as jobs
    from apex_tpu_torch import observability as obs
    images, labels = _data()
    bad = {3, 7, 11, 12, 30}
    got = []
    for mk, reg, ring in (
            (DataLoader, obs.MetricsRegistry(), obs.EventRing(64)),
            (JLoader, jobs.MetricsRegistry(), jobs.EventRing(64))):
        loader = mk(images, labels, batch_size=8, seed=2, metrics=reg,
                    ring=ring, bad_record_fn=lambda i: i in bad)
        assert loader.ring is ring
        _stream(loader, 9)                 # into the second epoch
        st = loader.stats()
        wait = st.pop("load_wait")
        evs = [{k: v for k, v in e.items() if k != "t"}
               for e in ring.snapshot()]
        resumed = mk(images, labels, batch_size=8, seed=2,
                     metrics=type(reg)(), bad_record_fn=lambda i: i in bad)
        resumed.load_state_dict(loader.state_dict())
        got.append((st, sorted(wait), wait["count"], _metric_values(reg),
                    evs, _metric_values(resumed._metrics)))
    assert got[0] == got[1]
    st, _, count, metrics, evs, after = got[0]
    assert count == 9 and st["samples_quarantined"] == len(evs) > 0
    assert metrics["data_samples_consumed"] == ("Gauge", 72.0)
    assert after["data_samples_consumed"] == ("Gauge", 72.0)
    assert {e["kind"] for e in evs} == {"data_sample_quarantined"}


_BUILDER = """
import sys, time
from pathlib import Path
sys.path.insert(0, {repo!r})
import apex_tpu_torch._native as native
native.BUILD_DIR = Path(sys.argv[1])
while time.time() < float(sys.argv[2]):
    pass
import numpy as np
x = np.full((2, 3, 4, 3), 7, np.uint8)
y = native.preprocess_images(x, (1.0, 2.0, 3.0), (2.0, 2.0, 2.0))
print(native.available(), native.error(), float(y[0, 0, 0, 0]))
"""


def test_library_build_under_concurrency(tmp_path):
    """Six processes start at one instant on an empty build directory;
    each compiles to its own temporary file and renames it into place, so
    every one loads a whole library and no temporary file is left."""
    import time
    build = tmp_path / "build"
    start = time.time() + 2.0
    procs = [subprocess.Popen(
        [sys.executable, "-c", _BUILDER.format(repo=REPO), str(build),
         str(start)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for _ in range(6)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.split() == ["True", "None", "3.0"], (out, err)
    files = sorted(f.name for f in build.iterdir())
    assert len(files) == 1 and files[0].startswith("libapex_tpu_torch_C-")
