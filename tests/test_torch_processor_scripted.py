"""The port's Processor against the JAX one on real maps: each package's
``inference.generate`` runs with its ``Processor.model_generate`` patched to
return the same per-window token scripts, built from the fixture maps of
``tests/test_e2e_osu_parity.py`` as its ``_window_scripts`` builds them. The
prompts handed to ``model_generate`` (conditional and, under CFG,
unconditional) must be equal call by call, and the written .osu bytes equal.
The decode is scripted, so no model runs: this holds the host half of
generation (windows, prompts, context bookkeeping, timing, resnap, render) on
maps with hit objects, which random weights never give. Under ``-cn v31``
and ``-cn v30`` the window conditions handed to ``model_generate`` (the
difficulty, mapper and song position the embedders read) must be equal too.
"""

import collections

import numpy as np
import pytest

import inference as jax_inference
from mapperatorinator_tpu.config import compose, schema
from mapperatorinator_tpu.infer.preprocessor import Preprocessor as JaxPreprocessor
from mapperatorinator_tpu.infer.processor import Processor as JaxProcessor
from mapperatorinator_tpu.osu import build_vocabulary as jax_build_vocabulary
from mapperatorinator_tpu.osu.beatmap import Beatmap as JaxBeatmap
from mapperatorinator_tpu.osu.parsing import BeatmapParser as JaxBeatmapParser
from mapperatorinator_tpu_torch import inference
from mapperatorinator_tpu_torch.config import load_config
from mapperatorinator_tpu_torch.infer.processor import Processor
from mapperatorinator_tpu_torch.osu import build_vocabulary
from mapperatorinator_tpu_torch.osu.beatmap import Beatmap
from tests.fixtures.tiny_checkpoint import REPO_ROOT, make_wav
from tests.test_e2e_osu_parity import FIXTURES, _window_scripts

SRC_LEN, TGT_LEN = 256, 192


def overrides(wav, gamemode, cfg_scale):
    o = [f"audio_path={wav}", f"train.data.src_seq_len={SRC_LEN}",
         f"train.data.tgt_seq_len={TGT_LEN}", f"gamemode={gamemode}", "difficulty=4.5", "seed=7",
         "do_sample=false", "num_beams=1", f"cfg_scale={cfg_scale}", "parallel=false", "title=ParityFixture",
         "artist=pytest", "creator=parity", "version=e2e", "tags=parity", "bpm=120", "offset=0", "device=cpu"]
    if gamemode == 3:
        o += ["keycount=4", "hold_note_ratio=0.2", "scroll_speed_ratio=0.5"]
    if cfg_scale > 1:
        o += ['descriptors=["clean"]', 'negative_descriptors=["messy"]']
    return o


def scripted(calls, scripts, eos_id):
    counters = {}

    def model_generate(self, frames, cond_prompt, uncond_prompt, model_kwargs, lookback_time=0, lookahead_time=0,
                       context_type=None):
        ctx = context_type.value
        idx = counters.get(ctx, 0)
        counters[ctx] = idx + 1
        cond_prompt = np.asarray(cond_prompt)
        calls.append((ctx, cond_prompt.tolist(), None if uncond_prompt is None else np.asarray(uncond_prompt).tolist(),
                      {k: (np.asarray(v).dtype.kind, np.asarray(v).tolist()) for k, v in model_kwargs.items()}))
        script = scripts[ctx][idx] if ctx in scripts else np.asarray([eos_id], np.int64)
        return np.concatenate([cond_prompt, np.repeat(script[None], len(cond_prompt), axis=0)], axis=-1)

    return model_generate


@pytest.mark.parametrize("gamemode,cfg_scale", [(0, 1.0), (0, 2.0), (1, 1.0), (2, 1.0), (3, 1.0)],
                         ids=["std", "std-cfg", "taiko", "catch", "mania"])
def test_scripted_tokens_give_the_jax_prompts_and_osu(tmp_path, monkeypatch, gamemode, cfg_scale):
    calls, windows = run_scripted(tmp_path, monkeypatch, "v32", gamemode,
                                  overrides(tmp_path / "song.wav", gamemode, cfg_scale))
    assert len(calls) > windows  # a timing pass, then a map pass over the windows


# v31: descriptors, year, hitsounded, circle size and keycount tokens, types first,
# a pass each of TIMING, KIAI, MAP and SV (SV in mania only), each window conditioned
# on the difficulty, the mapper and its place in the song; v30: timing interwoven
# with MAP in one pass, no context
CONDITIONED = {
    "v31-std": ("v31", 0, ["year=2023", 'descriptors=["clean", "tech"]', "mapper_id=101602", "circle_size=4.2"]),
    "v31-mania": ("v31", 3, ["year=2016", "mapper_id=-5", "hitsounded=false"]),
    "v30-std": ("v30", 0, ["mapper_id=101602"]),
}


@pytest.mark.parametrize("case", sorted(CONDITIONED))
def test_scripted_tokens_give_the_jax_prompts_conditions_and_osu_of_v31_v30(tmp_path, monkeypatch, case):
    name, gamemode, extra = CONDITIONED[case]
    calls, windows = run_scripted(tmp_path, monkeypatch, name, gamemode,
                                  [*overrides(tmp_path / "song.wav", gamemode, 1.0), *extra])
    passes = collections.Counter(call[0] for call in calls)
    want = ["map"] if name == "v30" else ["timing", "kiai", "map"] + (["sv"] if gamemode == 3 else [])
    assert passes == dict.fromkeys(want, windows)  # every pass decodes every window once
    assert all(set(call[3]) == {"difficulty", "mapper_idx", "song_position"} for call in calls)
    positions = [call[3]["song_position"][1][0] for call in calls if call[0] == calls[-1][0]]
    assert positions[0][0] == 0.0 and positions == sorted(positions)
    assert calls[0][3]["difficulty"] == ("f", [4.5])


# v28 and v29: no embedder, every condition a prompt token (gamemode, style,
# difficulty, mapper, year, hitsounded, song length, global SV, circle size,
# descriptors), out context types, types first, the kiai special token (v28
# only); super-timing off, so that each pass decodes its windows once
UNCONDITIONED = {
    "v28-std": ("v28", 0, ["beatmap_id=1234567", "year=2019", 'descriptors=["clean", "tech"]', "mapper_id=101602",
                           "circle_size=4.2", "slider_multiplier=1.6"]),
    "v29-taiko": ("v29", 1, ["beatmap_id=42", "year=2012", 'descriptors=["streams"]', "mapper_id=-5",
                             "hitsounded=false"]),
}


@pytest.mark.parametrize("case", sorted(UNCONDITIONED))
def test_scripted_tokens_give_the_jax_prompts_and_osu_of_v28_v29(tmp_path, monkeypatch, case):
    name, gamemode, extra = UNCONDITIONED[case]
    given = [*overrides(tmp_path / "song.wav", gamemode, 1.0), "super_timing=false", *extra]
    calls, windows = run_scripted(tmp_path, monkeypatch, name, gamemode, given)
    passes = collections.Counter(call[0] for call in calls)
    assert {"timing", "kiai", "map"} <= set(passes) and set(passes.values()) == {windows}
    assert all(call[3] == {} for call in calls)  # no embedder: the prompt carries every condition
    args = load_config(name, given)
    vocab = build_vocabulary(args.train)
    prompt = calls[-1][1][0]
    want = [vocab.encode_gamemode(gamemode), vocab.encode_diff(4.5), vocab.encode_year(args.year),
            vocab.encode_mapper_id(args.mapper_id), *(vocab.encode_descriptor_name(d) for d in args.descriptors)]
    assert all(token in prompt for token in want), (want, prompt)


def run_scripted(tmp_path, monkeypatch, name, gamemode, given):
    """Both packages' ``inference.generate`` under ``-cn name`` with the same
    scripted tokens: the prompts and conditions of every call equal, the
    .osu bytes equal. Returns the calls and the song's window count."""
    wav = make_wav(tmp_path / "song.wav", seconds=10.0)
    for side in ("jax", "torch"):
        (tmp_path / side).mkdir()
    jax_args = compose(REPO_ROOT / "configs" / "inference", name, schema_cls=schema.InferenceConfig,
                       overrides=[*given, f"output_path={tmp_path / 'jax'}"])
    args = load_config(name, [*given, f"output_path={tmp_path / 'torch'}"])
    jax_vocab, vocab = jax_build_vocabulary(jax_args.train), build_vocabulary(args.train)
    assert vocab.state_dict() == jax_vocab.state_dict()

    pre = JaxPreprocessor(jax_args)
    frame_times = [int(t) for t in pre.segment(pre.load(str(wav)))[1]]
    source = JaxBeatmap.from_path(FIXTURES[gamemode](tmp_path / "fixture.osu"))
    parser = JaxBeatmapParser(jax_args.train, jax_vocab)
    scripts = {"timing": _window_scripts(*parser.parse_timing(source), jax_vocab, frame_times),
               "map": _window_scripts(*parser.parse(source), jax_vocab, frame_times)}

    jax_calls, calls = [], []
    monkeypatch.setattr(JaxProcessor, "model_generate", scripted(jax_calls, scripts, jax_vocab.eos_id))
    monkeypatch.setattr(Processor, "model_generate", scripted(calls, scripts, vocab.eos_id))

    results = []
    for module, a, v in ((jax_inference, jax_args, jax_vocab), (inference, args, vocab)):
        module.compile_args(a, v, verbose=False)
        generation_config, beatmap_config = module.get_config(a)
        results.append(module.generate(a, generation_config=generation_config, beatmap_config=beatmap_config,
                                       engine=None, vocab=v, verbose=False))
    (want, want_path), (got, got_path) = results

    assert len(calls) == len(jax_calls)
    for i, (call, jax_call) in enumerate(zip(calls, jax_calls)):
        assert call == jax_call, f"call {i} ({jax_call[0]}): prompts or conditions differ"
    assert (jax_calls[0][2] is not None) == (args.cfg_scale > 1)
    assert got_path.read_bytes() == want_path.read_bytes()
    beatmap = Beatmap.from_path(got_path)
    assert beatmap.mode == gamemode and len(beatmap.hit_objects()) >= 10
    return calls, len(frame_times)
