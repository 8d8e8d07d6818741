"""The port's ``PENROZC1`` codec against the JAX package's: a checkpoint
serialized by ``penroz_tpu`` loads in the port with identical arrays
(fp32 and bf16), the port round-trips its own, and the JAX codec reads the
port's files."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from penroz_tpu.models.dsl import Mapper as JMapper
from penroz_tpu.models.model import NeuralNetworkModel as JModel
from penroz_tpu.utils import checkpoint as jckpt
from penroz_tpu_torch.models.dsl import Mapper
from penroz_tpu_torch.models.model import NeuralNetworkModel
from penroz_tpu_torch.utils import checkpoint as tckpt


@pytest.fixture
def shared_dir(workdir, monkeypatch):
    """Both packages read and write the same models/ and shm dirs."""
    monkeypatch.setattr(tckpt, "SHM_PATH", jckpt.SHM_PATH)
    return workdir


def _np_view(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


@pytest.mark.parametrize("dtype", [None, jnp.bfloat16], ids=["fp32", "bf16"])
def test_jax_checkpoint_loads_in_port(shared_dir, toy_gpt_layers,
                                      toy_optimizer, dtype):
    jm = JModel("shared", JMapper(toy_gpt_layers, toy_optimizer)).to(dtype)
    jm.progress = [{"epoch": 1, "cost": 2.5}]
    jm.serialize(sync_flush=True)
    data = tckpt.load("shared")
    assert data["layers"] == toy_gpt_layers
    assert data["progress"] == jm.progress
    assert len(data["opt_state_leaves"]) > 0  # carried, not yet used
    for key, arr in jm.state_dict().items():
        got = data["params"][key]
        assert got.dtype == (torch.bfloat16 if dtype else torch.float32)
        np.testing.assert_array_equal(_np_view(got), arr)
    tm = NeuralNetworkModel.deserialize("shared", device="cpu")
    assert tm.progress == jm.progress
    for key, arr in jm.state_dict().items():
        np.testing.assert_array_equal(_np_view(tm.state_dict()[key]), arr)
    assert tm.generate_tokens([1, 2, 3], 16, 6, temperature=0) == \
        jm.generate_tokens([1, 2, 3], 16, 6, temperature=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_port_round_trips_its_checkpoint(shared_dir, toy_gpt_layers,
                                         toy_optimizer, dtype):
    tm = NeuralNetworkModel("mine", Mapper(toy_gpt_layers, toy_optimizer),
                            device="cpu", seed=3)
    tm.arch.to(dtype)
    tm.status = {"code": "Created", "message": "ok"}
    tm.serialize(sync_flush=True)
    back = NeuralNetworkModel.deserialize("mine", device="cpu")
    assert back.dtype == dtype and back.status == tm.status
    for key, value in tm.state_dict().items():
        assert torch.equal(back.state_dict()[key], value), key
    # the JAX codec reads the port's file byte for byte
    jdata = jckpt.load("mine")
    for key, value in tm.state_dict().items():
        np.testing.assert_array_equal(jdata["params"][key], _np_view(value))
    NeuralNetworkModel.delete("mine")
    with pytest.raises(KeyError):
        NeuralNetworkModel.deserialize("mine", device="cpu")


def test_codec_detects_corruption():
    blob = bytearray(tckpt._encode({"w": torch.arange(64.0),
                                    "n": np.arange(3, dtype=np.int32),
                                    7: "int key"}))
    data = tckpt._decode(bytes(blob))
    assert torch.equal(data["w"], torch.arange(64.0))
    assert data["n"].dtype == torch.int32 and data[7] == "int key"
    assert bytes(blob) == jckpt._encode({"w": np.arange(64.0, dtype=np.float32),
                                         "n": np.arange(3, dtype=np.int32),
                                         7: "int key"})
    blob[-1] ^= 0xFF
    with pytest.raises(ValueError, match="CRC32"):
        tckpt._decode(bytes(blob))
    with pytest.raises(ValueError, match="truncated"):
        tckpt._decode(bytes(blob[:-8]))
    with pytest.raises(ValueError, match="magic"):
        tckpt._decode(b"PICKLE!!" + bytes(blob[8:]))
