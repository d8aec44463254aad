"""The serving demo of the port (examples/serving/demo_torch.py) run in
process on the CPU at a tiny size: the five ported modes print their
tokens and times, speculative decoding equals greedy, and the engine
modes are refused naming the queue item they wait for."""

import importlib.util
import os

import pytest
import torch

_PATH = os.path.join(os.path.dirname(__file__), "..", "examples", "serving",
                     "demo_torch.py")


def _demo():
    spec = importlib.util.spec_from_file_location("demo_torch", _PATH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_five_modes_run(capsys):
    demo = _demo()
    out = demo.main(["--device", "cpu", "--batch", "2", "--prompt", "6",
                     "--new", "8", "--layers", "2", "--width", "32",
                     "--vocab", "64", "--beams", "3", "--gamma", "3"])
    text = capsys.readouterr().out
    assert set(out) == set(demo.MODES)
    for mode in demo.MODES:
        ids = out[mode]
        assert ids.shape == (2, 14) and ids.device.type == "cpu"
        assert bool(((ids >= 0) & (ids < 64)).all())
        assert f"{mode:8s} row 0:" in text
    assert torch.equal(out["spec"], out["greedy"])
    assert torch.equal(out["greedy"][:, :6], out["beam"][:, :6])
    assert "speculative == greedy: True" in text and "done" in text


@pytest.mark.parametrize("mode", ["engine", "seq2seq"])
def test_engine_modes_wait_for_item_5(mode):
    with pytest.raises(NotImplementedError, match="item 5"):
        getattr(_demo(), f"run_{mode}")()
