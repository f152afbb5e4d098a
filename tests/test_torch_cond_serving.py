"""v31 and v30 served by the port against the JAX package, on the tiny
checkpoints of ``tests/test_torch_cond.py``:

* the ``.osu`` of ``inference.generate -cn v31`` and ``-cn v30`` byte-equal
  to the JAX package's on the same checkpoint and WAV, with the same
  conditions handed to the engine call by call; then the command line with
  ``precompile=true``, which warms a conditioned engine, writing the same map;
* the batching server: two clients' v31 windows, each with its own
  difficulty, mapper and song position, decoded in one batch; each client
  gets its rows of a direct call of the engine glue on that batch, which
  the JAX glue decodes to the same tokens.
"""

import threading

import numpy as np
import pytest
import torch

import inference as jax_inference
from mapperatorinator_tpu.config import compose, schema
from mapperatorinator_tpu.decode import DecodeEngine as JaxDecodeEngine
from mapperatorinator_tpu.infer import server as jax_server
from mapperatorinator_tpu_torch import inference
from mapperatorinator_tpu_torch.config import load_config
from mapperatorinator_tpu_torch.decode import DecodeEngine
from mapperatorinator_tpu_torch.infer import server
from mapperatorinator_tpu_torch.infer.server import InferenceClient, InferenceServer
from mapperatorinator_tpu_torch.osu import Vocabulary as PortVocabulary
from tests.fixtures.tiny_checkpoint import REPO_ROOT, SRC_SEQ_LEN, make_wav
from tests.test_torch_cond import (  # noqa: F401  (fixtures)
    TGT_SEQ_LEN,
    conditions,
    jax_loads_cond,
    make_tiny_cond_checkpoint,
    tiny_v31,
)
from tests.test_torch_decode import decode_prompt
from tests.test_torch_decode_graph import MAX_LEN
from tests.test_torch_model import audio
from tests.test_torch_server import generate_kwargs

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tiny_v30(tmp_path_factory):
    return make_tiny_cond_checkpoint(tmp_path_factory.mktemp("v30"), name="v30", seed=1)


@pytest.mark.parametrize("name", ["v31", "v30"])
def test_cli_osu_equals_jax(tiny_v31, tiny_v30, tmp_path, jax_loads_cond, name):  # noqa: F811
    ckpt = tiny_v31[0] if name == "v31" else tiny_v30
    wav = make_wav(tmp_path / "song.wav", seconds=1.5)
    overrides = [f"model_path={ckpt}", f"audio_path={wav}", f"train.data.src_seq_len={SRC_SEQ_LEN}",
                 f"train.data.tgt_seq_len={TGT_SEQ_LEN}", "do_sample=false", "seed=7", "gamemode=0",
                 "difficulty=6.5", "mapper_id=101602", "title=Conditioned", "artist=pytest", "bpm=120", "offset=0",
                 "device=cpu"]
    results = []
    for module in (jax_inference, inference):
        out = tmp_path / module.__name__
        out.mkdir()
        if module is jax_inference:
            args = compose(REPO_ROOT / "configs" / "inference", name, schema_cls=schema.InferenceConfig,
                           overrides=[*overrides, f"output_path={out}"])
        else:
            args = load_config(name, [*overrides, f"output_path={out}"])
        engine, vocab = module.load_model(args)
        conds = []
        inner = engine.encode_with_cond

        def recording(frames, cond=None, _inner=inner, _conds=conds):
            _conds.append({k: np.asarray(v).tolist() for k, v in (cond or {}).items()})
            return _inner(frames, cond)

        engine.encode_with_cond = recording
        module.compile_args(args, vocab, verbose=False)
        generation_config, beatmap_config = module.get_config(args)
        text, path = module.generate(args, generation_config=generation_config, beatmap_config=beatmap_config,
                                     engine=engine, vocab=vocab, verbose=False)
        results.append((conds, text, path.read_bytes()))
    (want_conds, want, want_bytes), (got_conds, got, got_bytes) = results
    assert got_conds == want_conds and len(got_conds) > 0
    assert set(got_conds[0]) == {"difficulty", "mapper_idx", "song_position"}
    assert got_conds[0]["difficulty"] == [6.5] and got_conds[0]["mapper_idx"] not in ([-1], [vocab.num_mapper_classes])
    assert got == want and got_bytes == want_bytes
    assert f"Version:Mapperatorinator {name.upper()}" in got

    # the command line, with the decode buffers and prefills warmed first
    (tmp_path / "cli").mkdir()
    text, _ = inference.main(["-cn", name, *overrides, f"output_path={tmp_path / 'cli'}", "precompile=true"])
    assert text == got


def test_two_v31_clients_decode_in_one_batch_as_a_direct_call(tiny_v31, tmp_path):  # noqa: F811
    _, jmodel, jparams, tmodel, vocab = tiny_v31
    port_fn = server.make_engine_generate_fn(DecodeEngine(tmodel, MAX_LEN, vocab.pad_id, device="cpu"),
                                             PortVocabulary.from_state_dict(vocab.state_dict()))
    jax_fn = jax_server.make_engine_generate_fn(JaxDecodeEngine(jmodel, jparams, MAX_LEN, vocab.pad_id), vocab)
    batches = []

    def recording(model_kwargs, generate_kwargs):
        batches.append(({k: v.copy() for k, v in model_kwargs.items()}, dict(generate_kwargs)))
        return port_fn(model_kwargs, generate_kwargs)

    srv = InferenceServer(recording, max_batch_size=8, batch_timeout=1.0, idle_timeout=60,
                          socket_path=str(tmp_path / "s.sock"))
    srv.start()
    ids, frames = decode_prompt(vocab, 2), audio(2)
    cond = conditions(2, jmodel.config.num_mappers)  # difficulty 0 and 10, mapper -1 and 0, two song ranges
    results = {}
    barrier = threading.Barrier(2)

    def request(i):
        client = InferenceClient(socket_path=srv.socket_path)
        barrier.wait(timeout=10)
        n = (ids[i] != vocab.pad_id).sum()
        kwargs = {"frames": frames[i:i + 1], "decoder_input_ids": ids[i:i + 1, -n:],
                  **{k: v[i:i + 1] for k, v in cond.items()}}
        results[i] = (client.generate(kwargs, generate_kwargs(1.0)), client.last_generation_stats)
        client.close()

    try:
        threads = [threading.Thread(target=request, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        srv.stop()
    assert [b[0]["frames"].shape[0] for b in batches] == [2]
    batch = batches[0][0]
    order = [int(np.where((batch["frames"] == frames[i]).all(axis=1))[0][0]) for i in range(2)]
    for k, v in cond.items():  # each row's condition travels with its window
        np.testing.assert_array_equal(batch[k][order], v)
    direct, _ = port_fn(*batches[0])
    want, _ = jax_fn(*batches[0])
    np.testing.assert_array_equal(direct, want)
    for i in range(2):
        out, stats = results[i]
        pad = ids.shape[1] - (ids[i] != vocab.pad_id).sum()
        np.testing.assert_array_equal(out, direct[order[i]:order[i] + 1, pad:])
        assert stats["generated_tokens"] > 10
