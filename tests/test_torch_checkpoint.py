"""Checkpoints on the port: the pure-Python msgpack reader and writer, the
port's ``save_checkpoint`` against the JAX loader, a quantized JAX checkpoint
in the port, the ``gamemode=N`` subfolder, and ``load_model`` quantizing the
stored weights before the cast to bf16.
"""

import flax.serialization
import flax.traverse_util
import msgpack
import numpy as np
import pytest
import torch

from mapperatorinator_tpu.models.io import load_checkpoint as jax_load_checkpoint
from mapperatorinator_tpu.models.io import quantize_checkpoint
from mapperatorinator_tpu.models.io import save_checkpoint as jax_save_checkpoint
from mapperatorinator_tpu.models.lora import resolve_model_checkpoint_path as jax_resolve
from mapperatorinator_tpu_torch import inference
from mapperatorinator_tpu_torch.config import load_config
from mapperatorinator_tpu_torch.models import flax_msgpack
from mapperatorinator_tpu_torch.models.io import load_checkpoint, quantize_model, read_flax_msgpack, save_checkpoint
from mapperatorinator_tpu_torch.models.params import flatten
from mapperatorinator_tpu_torch.models.transformer import QDense
from tests.fixtures.tiny_checkpoint import make_tiny_checkpoint
from tests.test_torch_model import tiny  # noqa: F401  (module fixture)

torch.set_num_threads(1)


def flat_numpy(tree) -> dict:
    return {k: np.asarray(v) for k, v in flax.traverse_util.flatten_dict(tree, sep="/").items()}


def assert_trees_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for key, value in want.items():
        assert got[key].dtype == value.dtype, key
        np.testing.assert_array_equal(got[key], value, err_msg=key)


def test_reader_matches_msgpack_and_writes_its_bytes(tiny):  # noqa: F811
    data = (tiny[0] / "params.msgpack").read_bytes()
    want = flatten(msgpack.unpackb(data, ext_hook=flax.serialization._msgpack_ext_unpack, raw=False))
    got = flatten(read_flax_msgpack(tiny[0] / "params.msgpack"))
    assert_trees_equal(got, want)
    assert flax_msgpack.packb(flax_msgpack.unpackb(data)) == data
    values = {"s": "x" * 40, "i": [0, 127, 128, -32, -33, 70000, -70000, 2**40], "f": 0.25, "b": b"\x00\x01",
              "n": None, "t": True, "a": np.arange(6, dtype=np.int8).reshape(2, 3), "c": np.float32(1.5)}
    packed = flax_msgpack.packb(values)
    assert packed == msgpack.packb(values, default=flax.serialization._msgpack_ext_pack, strict_types=True)
    back = flax_msgpack.unpackb(packed)
    np.testing.assert_array_equal(back.pop("a"), values["a"])
    assert back == {k: v for k, v in values.items() if k != "a"}


def test_chunked_arrays_raise(tmp_path):
    (tmp_path / "params.msgpack").write_bytes(flax_msgpack.packb({"w": {"__msgpack_chunked_array__": True}}))
    with pytest.raises(ValueError, match="chunked"):
        read_flax_msgpack(tmp_path / "params.msgpack")


@pytest.mark.parametrize("quantized", [False, True])
def test_save_checkpoint_loads_in_jax(tiny, tmp_path, quantized):  # noqa: F811
    directory, jmodel, jparams, tmodel, vocab = tiny
    model = quantize_model(tmodel) if quantized else tmodel
    port_vocab = load_checkpoint(directory)[1]
    save_checkpoint(tmp_path / "out", model.cfg, model.state_dict(), port_vocab)
    got_model, got, got_vocab = jax_load_checkpoint(tmp_path / "out")
    want_model, want = jmodel, jparams
    if quantized:
        want_model, want = quantize_checkpoint(jmodel, jparams)
    assert got_model.config == want_model.config
    assert_trees_equal(flat_numpy(got), flat_numpy(want))
    assert got_vocab.state_dict() == vocab.state_dict()


def test_quantized_jax_checkpoint_loads_into_the_port(tiny, tmp_path):  # noqa: F811
    directory, jmodel, jparams, tmodel, vocab = tiny
    qmodel, qparams = quantize_checkpoint(jmodel, jparams)
    jax_save_checkpoint(tmp_path / "q", qmodel.config, qparams, vocab)
    model, _ = load_checkpoint(tmp_path / "q")
    assert model.cfg.backbone.quantized_weights
    assert sum(isinstance(m, QDense) for m in model.modules()) == 23
    want = quantize_model(tmodel).state_dict()
    got = model.state_dict()
    assert set(got) == set(want)
    for name, tensor in want.items():
        assert torch.equal(got[name], tensor), name


def test_gamemode_subfolder_is_preferred(tmp_path, capsys):
    base = make_tiny_checkpoint(tmp_path / "ckpt", seed=0)
    sub = make_tiny_checkpoint(tmp_path / "ckpt" / "gamemode=0", seed=1)
    for gamemode, auto, want in ((0, True, sub), (0, False, base), (1, True, base)):
        assert str(jax_resolve(str(base), gamemode, auto)) == str(want)
        args = load_config("v32", [f"model_path={base}", f"gamemode={gamemode}", "device=cpu",
                                   f"auto_select_gamemode_model={str(auto).lower()}"])
        engine, _ = inference.load_model(args)
        notice = "Using gamemode-specific model checkpoint" in capsys.readouterr().out
        assert notice == (want == sub)
        expected = load_checkpoint(want)[0].state_dict()
        assert all(torch.equal(t, expected[n]) for n, t in engine.model.state_dict().items())


def test_bf16_precision_keeps_int8_scales_fp32(tiny):  # noqa: F811
    args = load_config("v32", [f"model_path={tiny[0]}", "device=cpu", "precision=bf16", "quantized_weights=true"])
    engine, _ = inference.load_model(args)
    model = engine.model
    assert model.cfg.backbone.dtype == torch.bfloat16
    layers = [m for m in model.modules() if isinstance(m, QDense)]
    assert len(layers) == 23
    assert all(m.scale.dtype == torch.float32 and m.kernel_q.dtype == torch.int8 for m in layers)
    # quantized from the stored fp32 weights, not from bf16 ones
    want = quantize_model(load_checkpoint(tiny[0])[0]).state_dict()
    assert all(torch.equal(m.scale, want[f"{n}.scale"]) for n, m in model.named_modules() if isinstance(m, QDense))
