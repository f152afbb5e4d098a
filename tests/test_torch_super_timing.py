"""The port's super-timing ensemble (``infer/super_timing.py``, a copy of the
JAX module) on the port's Processor:

* the analysis held to ``tests/fixtures/super_timing_golden.json`` in every
  scenario of ``tests/test_super_timing_golden.py``, and the offsets drawn;
* the pooled ensemble decode (every member's windows in shared batches of
  more than one row) with greedy tokens equal to the JAX
  ``SuperTimingGenerator._decode_iterations``, stream for stream;
* ``super_timing=true`` through ``inference.main`` writing the JAX package's
  .osu.
"""

import json

import numpy as np
import pytest
import torch

import inference as jax_inference
from mapperatorinator_tpu.config import compose, schema
from mapperatorinator_tpu.infer.processor import GenerationConfig as JaxGenerationConfig
from mapperatorinator_tpu.infer.processor import Processor as JaxProcessor
from mapperatorinator_tpu.infer.super_timing import SuperTimingGenerator as JaxSuperTimingGenerator
from mapperatorinator_tpu_torch import inference
from mapperatorinator_tpu_torch.config import load_config
from mapperatorinator_tpu_torch.infer.processor import GenerationConfig, Processor
from mapperatorinator_tpu_torch.infer.super_timing import SuperTimingGenerator
from mapperatorinator_tpu_torch.osu import build_vocabulary
from mapperatorinator_tpu_torch.osu.events import Event, EventType
from tests.fixtures.super_timing_streams import SCENARIOS, SONG_MS, build_streams
from tests.fixtures.tiny_checkpoint import REPO_ROOT, make_wav
from tests.test_torch_model import tiny  # noqa: F401  (module fixture)

torch.set_num_threads(1)
GOLDEN = json.loads((REPO_ROOT / "tests/fixtures/super_timing_golden.json").read_text())
GOLDEN_OVERRIDES = ["model_path=unused", "seed=5", "timer_iterations=6", "train.data.types_first=false"]


def port_events(events):
    """JAX events as the port's (each package has its own enum classes)."""
    return [Event(EventType(e.type.value), e.value) for e in events]


def golden_generator():
    args = load_config("v32", GOLDEN_OVERRIDES)
    return SuperTimingGenerator(args, engine=None, vocab=build_vocabulary(args.train))


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_analysis_matches_golden(scenario, monkeypatch):
    gen = golden_generator()
    expected = GOLDEN[scenario]
    streams = [port_events(s) for s in build_streams(scenario, expected["offsets"])]
    monkeypatch.setattr(SuperTimingGenerator, "_decode_iterations",
                        lambda self, audio, offsets, generation_config, verbose=False: streams)
    audio = np.zeros(SONG_MS * gen.sample_rate // 1000, np.float32)
    events, event_times = gen.generate(audio, generation_config=None)
    assert [[e.type.name, None if e.value is None else int(e.value)] for e in events] == expected["events"]
    assert [int(t) for t in event_times] == expected["event_times"]


def test_offsets_match_golden():
    assert golden_generator()._draw_offsets() == GOLDEN["steady"]["offsets"]


def overrides(ckpt, wav, iterations):
    return [f"model_path={ckpt}", f"audio_path={wav}", "train.data.src_seq_len=256", "train.data.tgt_seq_len=128",
            "seed=11", f"timer_iterations={iterations}", "gamemode=0", "difficulty=4.0", "do_sample=false",
            "title=SuperTiming", "bpm=120", "offset=0", "device=cpu"]


def test_pooled_ensemble_decode_matches_jax(tiny, tmp_path, monkeypatch):  # noqa: F811
    """Every pooled batch's tokens (the random tiny model's, which the timing
    context keeps no event of) and the streams parsed from them."""
    wav = make_wav(tmp_path / "song.wav", seconds=3.0)
    decoded, streams = ([], []), []
    for (module, gen_cls, config_cls, processor_cls), calls in zip(
            ((jax_inference, JaxSuperTimingGenerator, JaxGenerationConfig, JaxProcessor),
             (inference, SuperTimingGenerator, GenerationConfig, Processor)), decoded):
        run = processor_cls.model_generate

        def recording(self, frames, *a, _run=run, _calls=calls, **kw):
            tokens = _run(self, frames, *a, **kw)
            _calls.append(np.asarray(tokens))
            return tokens

        monkeypatch.setattr(processor_cls, "model_generate", recording)
        o = overrides(tiny[0], wav, iterations=3)
        args = compose(REPO_ROOT / "configs" / "inference", "v32", overrides=o, schema_cls=schema.InferenceConfig) \
            if module is jax_inference else load_config("v32", o)
        engine, vocab = module.load_model(args)
        gen = gen_cls(args, engine, vocab)
        audio = gen.preprocessor.load(str(wav))
        streams.append([[(e.type.value, e.value) for e in s]
                        for s in gen._decode_iterations(audio, gen._draw_offsets(),
                                                        config_cls(gamemode=0, difficulty=4.0))])
    (want_calls, got_calls), (want, got) = decoded, streams
    assert len(got_calls) == len(want_calls) > 0
    for w, g in zip(want_calls, got_calls):
        assert g.shape == w.shape and g.shape[0] > 1
        np.testing.assert_array_equal(g, w)
        assert (g[:, -1] != 0).any()  # a row that decoded to max_length
    assert len(got) == len(want) == 3 and got == want


def test_super_timing_run_writes_the_jax_osu(tiny, tmp_path):  # noqa: F811
    wav = make_wav(tmp_path / "song.wav", seconds=3.0)
    texts = []
    for module in (jax_inference, inference):
        out = tmp_path / module.__name__
        out.mkdir()
        argv = ["-cn", "v32", *overrides(tiny[0], wav, iterations=2), f"output_path={out}", "super_timing=true"]
        texts.append(module.main(argv)[0])
    assert texts[1] == texts[0] and "[HitObjects]" in texts[1]
