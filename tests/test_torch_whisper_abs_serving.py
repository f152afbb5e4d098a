"""The v28 and v29 presets served by the port against the JAX package, from
a published (HF-format) checkpoint that both packages load
(``tests/test_torch_convert.py`` writes it at tiny widths):

* ``inference.load_model`` / ``generate`` under ``-cn v28`` (super-timing as
  the preset composes it, at two members) and ``-cn v29``, greedy: the
  tokens of every decode call and the .osu bytes equal;
* v29's preset as it composes (sampled at temperature 0.9, top-p 0.9, which
  reach the decode calls' logits chains) writes a readable map;
* one v29 request with ``generate_positions=true`` and a tiny DiT bundle
  that both packages load, on the scripted tokens of
  ``tests/test_torch_diffusion_generate.py``: the same .osu bytes.
"""

import functools

import numpy as np
import pytest
import torch

import inference as jax_inference
from mapperatorinator_tpu.config import compose, schema
from mapperatorinator_tpu.infer import diffusion_pipeline as jax_diffusion_pipeline
from mapperatorinator_tpu.infer.preprocessor import Preprocessor as JaxPreprocessor
from mapperatorinator_tpu.infer.processor import Processor as JaxProcessor
from mapperatorinator_tpu.osu import build_vocabulary as jax_build_vocabulary
from mapperatorinator_tpu.osu.beatmap import Beatmap as JaxBeatmap
from mapperatorinator_tpu.osu.parsing import BeatmapParser as JaxBeatmapParser
from mapperatorinator_tpu_torch import inference
from mapperatorinator_tpu_torch.config import load_config
from mapperatorinator_tpu_torch.infer.diffusion_pipeline import DiffusionPipeline
from mapperatorinator_tpu_torch.infer.processor import Processor
from mapperatorinator_tpu_torch.models.io import save_dit_bundle
from mapperatorinator_tpu_torch.osu import build_vocabulary
from mapperatorinator_tpu_torch.osu.beatmap import Beatmap
from tests.fixtures.tiny_checkpoint import REPO_ROOT, make_wav
from tests.test_e2e_osu_parity import _window_scripts
from tests.test_torch_convert import SRC_LEN, TGT_LEN, write_hf_checkpoint
from tests.test_torch_diffusion_pipeline import CUT, jax_noise, jax_pipeline, make_map, models
from tests.test_torch_processor_scripted import scripted

torch.set_num_threads(1)


def recorded_generate(tmp_path, name, overrides):
    """Each package's ``load_model`` / ``generate`` under ``-cn name``: the
    tokens of every decode call, the .osu text and path."""
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
        decoded = []
        inner = engine.generate

        def recording(*a, _inner=inner, _decoded=decoded, **kw):
            tokens, end = _inner(*a, **kw)
            _decoded.append((np.asarray(tokens).tolist(), int(end)))
            return tokens, end

        engine.generate = recording
        module.compile_args(args, vocab, verbose=False)
        generation_config, beatmap_config = module.get_config(args)
        text, path = module.generate(args, generation_config=generation_config, beatmap_config=beatmap_config,
                                     engine=engine, vocab=vocab, verbose=False)
        results.append((decoded, text, path, args))
    return results


@pytest.mark.parametrize("name", ["v28", "v29"])
def test_preset_greedy_tokens_and_osu_equal_jax(tmp_path, name):
    """v28 with super-timing as its preset composes it (two members), v29
    greedy: from the HF directory, every decode call's tokens and the .osu
    bytes equal."""
    directory, _, _ = write_hf_checkpoint(tmp_path / "ckpt", name)
    wav = make_wav(tmp_path / "song.wav", seconds=1.5)
    overrides = [f"model_path={directory}", f"audio_path={wav}", f"train.data.src_seq_len={SRC_LEN}",
                 f"train.data.tgt_seq_len={TGT_LEN}", "do_sample=false", "seed=7", "gamemode=0", "timer_iterations=2",
                 "title=Whisper", "artist=pytest", "bpm=120", "offset=0", "device=cpu"]
    (want_tokens, want, want_path, jargs), (got_tokens, got, got_path, args) = recorded_generate(
        tmp_path, name, overrides)
    assert args.super_timing and jargs.super_timing and args.generate_positions
    assert len(got_tokens) == len(want_tokens) > (2 if name == "v28" else 0)
    assert got_tokens == want_tokens
    assert got == want and got_path.read_bytes() == want_path.read_bytes()
    assert f"Version:Mapperatorinator {name.upper()}" in got


def test_v29_preset_as_composed_writes_a_map(tmp_path):
    """Sampled at v29's temperature and top-p of 0.9, which reach the decode
    calls' logits chains, super-timing on (its members decode greedily)."""
    directory, _, _ = write_hf_checkpoint(tmp_path / "ckpt", "v29")
    wav = make_wav(tmp_path / "song.wav", seconds=1.5)
    args = load_config("v29", [f"model_path={directory}", f"audio_path={wav}", f"output_path={tmp_path}",
                               f"train.data.src_seq_len={SRC_LEN}", f"train.data.tgt_seq_len={TGT_LEN}",
                               "timer_iterations=2", "seed=3", "device=cpu"])
    jargs = compose(REPO_ROOT / "configs" / "inference", "v29", schema_cls=schema.InferenceConfig)
    assert (args.temperature, args.top_p, args.do_sample, args.super_timing) == (
        jargs.temperature, jargs.top_p, jargs.do_sample, jargs.super_timing) == (0.9, 0.9, True, True)
    engine, vocab = inference.load_model(args)
    chains = []
    inner = engine.generate
    engine.generate = lambda enc, ids, pipeline, *a, **kw: chains.append(pipeline) or inner(enc, ids, pipeline, *a,
                                                                                            **kw)
    inference.compile_args(args, vocab, verbose=False)
    generation_config, beatmap_config = inference.get_config(args)
    text, path = inference.generate(args, generation_config=generation_config, beatmap_config=beatmap_config,
                                    engine=engine, vocab=vocab, verbose=False)
    sampled = [c for c in chains if c.do_sample]
    assert sampled and all((c.temperature, c.top_p) == (0.9, 0.9) for c in sampled)
    assert any(not c.do_sample for c in chains)  # the super-timing members
    beatmap = Beatmap.from_path(path)
    assert beatmap.mode == 0 and "Version:Mapperatorinator V29.1" in text


def test_v29_generate_positions_with_a_dit_bundle_writes_the_jax_osu(tmp_path, monkeypatch):
    """``-cn v29`` with ``generate_positions=true``: each package's
    ``generate`` on the same scripted tokens (a slider map), the DiT and its
    refine DiT read from bundles the port wrote, the port given the JAX
    draws; v29 writes DISTANCE events, which the pipeline replaces by
    sampled positions."""
    wav = make_wav(tmp_path / "song.wav", seconds=10.0)
    for side in ("jax", "torch"):
        (tmp_path / side).mkdir()
    given = [f"audio_path={wav}", "train.data.src_seq_len=256", "train.data.tgt_seq_len=192", "gamemode=0",
             "super_timing=false", "do_sample=false", "parallel=false", "title=DiT", "artist=pytest",
             "creator=parity", "version=dit", "bpm=120", "offset=0", "device=cpu", "generate_positions=true",
             "refine_iters=2", *CUT]
    jax_args = compose(REPO_ROOT / "configs" / "inference", "v29", schema_cls=schema.InferenceConfig,
                       overrides=[*given, f"output_path={tmp_path / 'jax'}"])
    args = load_config("v29", [*given, f"output_path={tmp_path / 'torch'}"])
    assert args.train.data.add_distances and not args.train.data.position_split_axes
    jax_vocab, vocab = jax_build_vocabulary(jax_args.train), build_vocabulary(args.train)
    pre = JaxPreprocessor(jax_args)
    frame_times = [int(t) for t in pre.segment(pre.load(str(wav)))[1]]
    source = JaxBeatmap.from_path(make_map(tmp_path / "map.osu", 24))
    parser = JaxBeatmapParser(jax_args.train, jax_vocab)
    scripts = {"timing": _window_scripts(*parser.parse_timing(source), jax_vocab, frame_times),
               "map": _window_scripts(*parser.parse(source), jax_vocab, frame_times)}
    monkeypatch.setattr(JaxProcessor, "model_generate", scripted([], scripts, jax_vocab.eos_id))
    monkeypatch.setattr(Processor, "model_generate", scripted([], scripts, vocab.eos_id))

    _, _, port_model, port_refine = models(refine=True)
    bundles = {}
    for label, model in (("dit", port_model), ("refine", port_refine)):
        save_dit_bundle(tmp_path / label, model)
        bundles[label] = (jax_inference.load_diffusion_model(str(tmp_path / label)),
                          inference.load_diffusion_model(tmp_path / label, torch.device("cpu")))
    pipelines = []
    monkeypatch.setattr(jax_diffusion_pipeline, "DiffusionPipeline",
                        lambda *a: pipelines.append(jax_pipeline(*a)) or pipelines[-1])
    monkeypatch.setattr(inference, "DiffusionPipeline", functools.partial(
        DiffusionPipeline, noise=jax_noise(3, False, 4)))

    results = []
    for side, module, a, v in ((0, jax_inference, jax_args, jax_vocab), (1, inference, args, vocab)):
        module.compile_args(a, v, verbose=False)
        generation_config, beatmap_config = module.get_config(a)
        results.append(module.generate(a, generation_config=generation_config, beatmap_config=beatmap_config,
                                       engine=None, vocab=v, verbose=False, diff_model=bundles["dit"][side],
                                       refine_model=bundles["refine"][side]))
    (want, want_path), (got, got_path) = results
    assert len(pipelines) == 1  # the JAX side refined too
    assert got_path.read_bytes() == want_path.read_bytes()
    beatmap = Beatmap.from_path(got_path)
    assert len(beatmap.hit_objects()) >= 10
    placed = {(h.x, h.y) for h in beatmap.hit_objects()}
    assert not placed <= {(h.x, h.y) for h in JaxBeatmap.from_path(tmp_path / "map.osu").hit_objects()}
