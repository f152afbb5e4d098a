"""The port's batching server (``infer/server.py``): the four cases of
``tests/test_server.py`` on the port's classes; the engine glue
(``make_engine_generate_fn``) against the JAX package's, greedy at B 2 and as
CFG 2 pairs, token for token; two clients whose windows the batch thread
decodes together, each getting the rows a direct call of the glue gives;
``use_server=true`` through ``inference.main`` writing the .osu of a run
without the server; socket names that never match the JAX server's; and the
launch counters' capture recording, which belongs to the capturing thread.
"""

import shutil
import tempfile
import threading

import numpy as np
import pytest
import torch

from mapperatorinator_tpu.decode import DecodeEngine as JaxDecodeEngine
from mapperatorinator_tpu.infer import server as jax_server
from mapperatorinator_tpu_torch import inference
from mapperatorinator_tpu_torch.decode import DecodeEngine
from mapperatorinator_tpu_torch.infer import server
from mapperatorinator_tpu_torch.infer.server import RETRY_SIGNAL, InferenceClient, InferenceServer
from mapperatorinator_tpu_torch.ops import launches
from mapperatorinator_tpu_torch.osu import Vocabulary as PortVocabulary
from tests.fixtures.tiny_checkpoint import SRC_SEQ_LEN, TGT_SEQ_LEN, make_wav
from tests.test_torch_decode import decode_prompt
from tests.test_torch_decode_graph import MAX_LEN, bucketed
from tests.test_torch_model import audio, tiny  # noqa: F401  (module fixture)

torch.set_num_threads(1)


def make_fake_generate(batch_sizes_seen, fail_first=False):
    state = {"calls": 0}

    def generate_fn(model_kwargs, generate_kwargs):
        state["calls"] += 1
        if fail_first and state["calls"] == 1:
            raise RuntimeError("boom")
        frames = model_kwargs["frames"]
        batch_sizes_seen.append(frames.shape[0])
        ids = model_kwargs["decoder_input_ids"]
        # echo: output = ids + 1, plus 2 generated columns of value 7
        out = np.concatenate([ids + 1, np.full((ids.shape[0], 2), 7, ids.dtype)], axis=1)
        stats = {
            "generated_tokens_per_sample": [2] * frames.shape[0],
            "elapsed_seconds": 0.01,
        }
        return out, stats

    return generate_fn


@pytest.fixture
def socket_path(tmp_path):
    return str(tmp_path / "test.sock")


def test_server_roundtrip(socket_path):
    seen = []
    server = InferenceServer(make_fake_generate(seen), max_batch_size=8, batch_timeout=0.05,
                             idle_timeout=60, socket_path=socket_path)
    server.start()
    try:
        client = InferenceClient(socket_path=socket_path)
        model_kwargs = {
            "frames": np.zeros((2, 16), np.float32),
            "decoder_input_ids": np.array([[1, 2], [3, 4]], np.int32),
        }
        out = client.generate(model_kwargs, {"temperature": 1.0})
        np.testing.assert_array_equal(out, [[2, 3, 7, 7], [4, 5, 7, 7]])
        assert client.last_generation_stats["generated_tokens"] == 4
        client.close()
    finally:
        server.stop()


def test_server_splits_oversized_requests(socket_path):
    seen = []
    server = InferenceServer(make_fake_generate(seen), max_batch_size=2, batch_timeout=0.05,
                             idle_timeout=60, socket_path=socket_path)
    server.start()
    try:
        client = InferenceClient(socket_path=socket_path)
        n = 5
        model_kwargs = {
            "frames": np.zeros((n, 16), np.float32),
            "decoder_input_ids": np.arange(n * 2, dtype=np.int32).reshape(n, 2),
        }
        out = client.generate(model_kwargs, {"temperature": 1.0})
        assert out.shape[0] == n
        np.testing.assert_array_equal(out[:, :2], model_kwargs["decoder_input_ids"] + 1)
        assert max(seen) <= 2
        assert sum(seen) == n
        client.close()
    finally:
        server.stop()


def test_server_batches_multiple_clients(socket_path):
    seen = []
    server = InferenceServer(make_fake_generate(seen), max_batch_size=8, batch_timeout=0.1,
                             idle_timeout=60, socket_path=socket_path)
    server.start()
    try:
        results = {}

        def worker(i):
            client = InferenceClient(socket_path=socket_path)
            model_kwargs = {
                "frames": np.zeros((1, 16), np.float32),
                "decoder_input_ids": np.array([[i, i]], np.int32),
            }
            results[i] = client.generate(model_kwargs, {"temperature": 1.0})
            client.close()

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=20)
        assert not any(t.is_alive() for t in threads)
        assert len(results) == 4
        for i in range(4):
            np.testing.assert_array_equal(results[i][0, :2], [i + 1, i + 1])
        assert max(seen) >= 2
        assert sum(seen) == 4
    finally:
        server.stop()


def test_server_retry_on_error(socket_path):
    seen = []
    server = InferenceServer(make_fake_generate(seen, fail_first=True), max_batch_size=8,
                             batch_timeout=0.05, idle_timeout=60, socket_path=socket_path)
    server.start()
    try:
        client = InferenceClient(socket_path=socket_path)
        model_kwargs = {
            "frames": np.zeros((1, 16), np.float32),
            "decoder_input_ids": np.array([[9, 9]], np.int32),
        }
        out = client.generate(model_kwargs, {"temperature": 1.0})
        np.testing.assert_array_equal(out, [[10, 10, 7, 7]])
        client.close()
    finally:
        server.stop()
    assert RETRY_SIGNAL == jax_server.RETRY_SIGNAL


def test_socket_names_never_match_the_jax_server():
    for key in (("ckpt", None, 0), ("OliBomby/Mapperatorinator-v32", "lora", 3), ("", None, None)):
        ours, theirs = server.get_server_address(*key), jax_server.get_server_address(*key)
        assert ours != theirs and "mapperatorinator_tpu_torch_" in ours
        assert ours == server.get_server_address(*key)
    assert server.SOCKET_PATH != jax_server.SOCKET_PATH
    assert server.get_server_address("a", None, 0) != server.get_server_address("a", None, 1)


def generate_kwargs(cfg_scale: float) -> dict:
    """The greedy settings ``Processor.model_generate`` sends, at MAX_LEN."""
    return {"cfg_scale": cfg_scale, "do_sample": False, "num_beams": 1, "temperature": 0.9,
            "timing_temperature": 0.1, "mania_column_temperature": 0.8, "taiko_hit_temperature": 0.8,
            "top_k": 0, "top_p": 0.9, "timeshift_bias": 0.0, "types_first": False, "lookback_time": 0.0,
            "lookahead_time": 0.0, "context_type": None, "max_length": MAX_LEN}


@pytest.fixture(scope="module")
def glue(tiny):  # noqa: F811
    """Both packages' engine glue over the tiny checkpoint's engines (bucket 16, MAX_LEN)."""
    _, jmodel, jparams, tmodel, vocab = tiny
    jm, tm = bucketed(jmodel, tmodel)
    port_engine = DecodeEngine(tm, MAX_LEN, vocab.pad_id, device="cpu")
    return (jax_server.make_engine_generate_fn(JaxDecodeEngine(jm, jparams, MAX_LEN, vocab.pad_id), vocab),
            server.make_engine_generate_fn(port_engine, PortVocabulary.from_state_dict(vocab.state_dict())), vocab)


@pytest.mark.parametrize("cfg_scale", [1.0, 2.0])
def test_engine_glue_matches_jax(glue, cfg_scale):
    jax_fn, port_fn, vocab = glue
    ids = decode_prompt(vocab, 2)
    model_kwargs = {"frames": audio(2), "decoder_input_ids": ids}
    if cfg_scale > 1:
        model_kwargs["uncond_prompt"] = np.concatenate([np.zeros((2, 2), ids.dtype), ids[:, :-2]], axis=1)
    want, want_stats = jax_fn(dict(model_kwargs), generate_kwargs(cfg_scale))
    got, got_stats = port_fn(dict(model_kwargs), generate_kwargs(cfg_scale))
    assert got.shape == want.shape == (2, MAX_LEN)
    np.testing.assert_array_equal(got, want)
    assert got_stats["generated_tokens_per_sample"] == want_stats["generated_tokens_per_sample"]
    assert min(got_stats["generated_tokens_per_sample"]) > 10


def test_two_clients_decode_in_one_batch_as_a_direct_call(glue, tmp_path):
    _, port_fn, vocab = glue
    batches = []

    def recording(model_kwargs, generate_kwargs):
        batches.append(({k: v.copy() for k, v in model_kwargs.items()}, dict(generate_kwargs)))
        return port_fn(model_kwargs, generate_kwargs)

    srv = InferenceServer(recording, max_batch_size=8, batch_timeout=1.0, idle_timeout=60,
                          socket_path=str(tmp_path / "s.sock"))
    srv.start()
    ids, frames = decode_prompt(vocab, 2), audio(2)
    results = {}
    barrier = threading.Barrier(2)

    def request(i):
        client = InferenceClient(socket_path=srv.socket_path)
        barrier.wait(timeout=10)
        n = (ids[i] != vocab.pad_id).sum()
        results[i] = (client.generate({"frames": frames[i:i + 1], "decoder_input_ids": ids[i:i + 1, -n:]},
                                      generate_kwargs(1.0)), client.last_generation_stats)
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
    direct, _ = port_fn(*batches[0])
    order = [int(np.where((batches[0][0]["frames"] == frames[i]).all(axis=1))[0][0]) for i in range(2)]
    for i in range(2):
        out, stats = results[i]
        n = (ids[i] != vocab.pad_id).sum()
        pad = ids.shape[1] - n
        np.testing.assert_array_equal(out, direct[order[i]:order[i] + 1, pad:])
        assert stats["generated_tokens"] > 10 and stats["tokens_per_second"] > 0


def test_use_server_writes_the_osu_of_a_run_without_it(tiny, tmp_path, monkeypatch):  # noqa: F811
    wav = make_wav(tmp_path / "song.wav", seconds=3.0)
    base = [f"model_path={tiny[0]}", f"audio_path={wav}", f"train.data.src_seq_len={SRC_SEQ_LEN}",
            f"train.data.tgt_seq_len={TGT_SEQ_LEN}", "do_sample=false", "seed=7", "gamemode=0", "device=cpu",
            "title=Served", "bpm=120", "offset=0"]
    clients = []

    class Recorded(InferenceClient):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            clients.append(self)

    monkeypatch.setattr(inference, "InferenceClient", Recorded)
    # the socket goes to the temporary directory; a short one of its own, since a
    # Unix socket's path is limited to 107 bytes
    sockets = tempfile.mkdtemp(prefix="mts")
    monkeypatch.setattr(tempfile, "tempdir", sockets)
    texts = []
    try:
        for use_server in (False, True):
            out = tmp_path / str(use_server)
            out.mkdir()
            texts.append(inference.main(["-cn", "v32", *base, f"output_path={out}",
                                         f"use_server={str(use_server).lower()}"])[0])
        assert len(clients) == 1 and clients[0]._owned_server is not None
        assert clients[0].socket_path.startswith(sockets)
    finally:
        for client in clients:
            client.close()
            if client._owned_server is not None:
                client._owned_server.stop()
        shutil.rmtree(sockets, ignore_errors=True)
    assert texts[1] == texts[0] and "[HitObjects]" in texts[1]


def test_a_capture_records_its_own_threads_launches_only(monkeypatch):
    # a CPU build of torch has no stream to ask; an eager launch is never inside a capture here
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    def fn():  # a kernel wrapper's counters
        pass

    fn.launches = 0
    recording = launches.collections.Counter()
    inside = threading.Event()
    done = threading.Event()

    def capturing():
        launches._capturing.recording = recording
        try:
            launches.count(fn, "launches")
            inside.set()
            done.wait(timeout=10)
        finally:
            launches._capturing.recording = None

    t = threading.Thread(target=capturing)
    t.start()
    assert inside.wait(timeout=10)
    launches.count(fn, "launches")  # an eager launch in another thread, during the capture
    done.set()
    t.join(timeout=10)
    assert not t.is_alive()
    assert fn.launches == 1 and recording == {(fn, "launches"): 1}
