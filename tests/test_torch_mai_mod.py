"""MaiMod on the port against the JAX package: ``Processor.ai_mod`` (the
teacher-forced analysis, the engine's ``forward_stats``) on the tiny
checkpoint, ``SIMPLE_OSU`` and an 8 s WAV, without and with CFG. The
surprisal and entropy each ``forward_stats`` call returns must agree at the
model bar (2e-4, as ``tests/test_torch_engine.py`` holds ``forward_stats``)
with equal argmax ids; per analysed event, the relative surprisals must agree
at that bar and the expected events and rendered strings must be equal. Then
``run_analysis`` (the MaiMod entry point of the web UIs) in each package:
equal suggestion records, surprisals within the bar. The port's command line
runs on the same inputs. A map whose mode the config does not cover falls
back to v31, with the JAX arguments and the JAX records.
"""

import numpy as np
import pytest
import torch

import inference as jax_inference
import mai_mod as jax_mai_mod
from mapperatorinator_tpu.config import compose, schema
from mapperatorinator_tpu.infer import Preprocessor as JaxPreprocessor
from mapperatorinator_tpu.infer import Processor as JaxProcessor
from mapperatorinator_tpu.infer.processor import GenerationConfig as JaxGenerationConfig
from mapperatorinator_tpu_torch import inference
from mapperatorinator_tpu_torch import mai_mod
from mapperatorinator_tpu_torch.config import load_config
from mapperatorinator_tpu_torch.infer import Preprocessor, Processor
from mapperatorinator_tpu_torch.infer.processor import GenerationConfig
from tests.fixtures.tiny_checkpoint import REPO_ROOT, SRC_SEQ_LEN, TGT_SEQ_LEN, make_tiny_checkpoint, make_wav
from tests.test_beatmap import SIMPLE_OSU
from tests.test_torch_cond import TGT_SEQ_LEN as COND_TGT_SEQ_LEN
from tests.test_torch_cond import jax_loads_cond, make_tiny_cond_checkpoint  # noqa: F401  (fixture)
from tests.test_torch_config import plain as config_plain

torch.set_num_threads(1)
TOL = 2e-4


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    tmp_path = tmp_path_factory.mktemp("mai_mod")
    osu = tmp_path / "fixture.osu"
    osu.write_text(SIMPLE_OSU)
    return make_tiny_checkpoint(tmp_path / "ckpt"), make_wav(tmp_path / "song.wav", seconds=8.0), osu


def overrides(ckpt, wav, osu, cfg_scale=1.0):
    o = [f"model_path={ckpt}", f"audio_path={wav}", f"beatmap_path={osu}", "seed=3", "device=cpu",
         f"train.data.src_seq_len={SRC_SEQ_LEN}", f"train.data.tgt_seq_len={TGT_SEQ_LEN}", f"cfg_scale={cfg_scale}"]
    if cfg_scale > 1:
        o += ['descriptors=["clean"]', 'negative_descriptors=["messy"]']
    return o


def jax_args(o):
    return compose(REPO_ROOT / "configs" / "inference", "v32", overrides=o, schema_cls=schema.InferenceConfig)


def recorded(engine, calls):
    """Record each ``forward_stats`` call's (ids shape, surprisal, entropy, argmax)."""
    inner = engine.forward_stats

    def forward_stats(encoder_states, ids, *a, **kw):
        out = inner(encoder_states, ids, *a, **kw)
        calls.append((np.asarray(ids).shape, *(np.asarray(x) for x in out)))
        return out

    engine.forward_stats = forward_stats


def plain(x):
    """An event or a rendered string as comparable data (each package has its own Event class)."""
    if isinstance(x, str) or x is None:
        return x
    return (x.type.value, None if x.value is None else int(x.value))


@pytest.mark.parametrize("cfg_scale", [1.0, 2.0])
def test_ai_mod_statistics_and_events_match_jax(inputs, cfg_scale):
    ckpt, wav, osu = inputs
    results, calls = [], ([], [])
    sides = ((jax_inference, jax_args, JaxPreprocessor, JaxProcessor, JaxGenerationConfig),
             (inference, lambda o: load_config("v32", o), Preprocessor, Processor, GenerationConfig))
    for (module, load, pre_cls, proc_cls, gen_cls), side_calls in zip(sides, calls):
        args = load(overrides(ckpt, wav, osu, cfg_scale))
        engine, vocab = module.load_model(args)
        recorded(engine, side_calls)
        pre = pre_cls(args, parallel=False)
        contexts = proc_cls(args, engine, vocab).ai_mod(
            sequences=pre.segment(pre.load(str(wav))),
            generation_config=gen_cls(gamemode=0, difficulty=4.0, descriptors=args.descriptors,
                                      negative_descriptors=args.negative_descriptors),
            beatmap_path=str(osu), verbose=False)
        results.append(contexts)

    want_calls, got_calls = calls
    assert len(got_calls) == len(want_calls) > 0
    for (w_shape, w_sur, w_ent, w_arg), (g_shape, g_sur, g_ent, g_arg) in zip(want_calls, got_calls):
        assert g_shape == w_shape and (cfg_scale == 1) == (g_shape[0] == g_sur.shape[0])
        np.testing.assert_array_equal(np.isnan(g_sur), np.isnan(w_sur))
        np.testing.assert_allclose(g_sur, w_sur, atol=TOL, rtol=TOL, equal_nan=True)
        np.testing.assert_allclose(g_ent, w_ent, atol=TOL, rtol=TOL)
        np.testing.assert_array_equal(g_arg, w_arg)

    want, got = results
    assert [c["context_type"].value for c in got] == [c["context_type"].value for c in want]
    analysed = 0
    for w, g in zip(want, got):
        assert [plain(e) for e in g["events"]] == [plain(e) for e in w["events"]]
        np.testing.assert_allclose(g["surprisals"], w["surprisals"], atol=TOL, rtol=TOL)
        for key in ("expected_events", "events_str", "expected_events_str"):
            assert [plain(x) for x in g[key]] == [plain(x) for x in w[key]], key
        analysed += sum(s is not None for s in g["events_str"])
    assert analysed > 20


def test_run_analysis_records_match_jax(inputs, capsys):
    ckpt, wav, osu = inputs
    want = jax_mai_mod.run_analysis(jax_args(overrides(ckpt, wav, osu)), surprisal_threshold=0.0)
    got = mai_mod.run_analysis(load_config("v32", overrides(ckpt, wav, osu)), surprisal_threshold=0.0)
    assert len(got) == len(want) > 10
    for g, w in zip(got, want):
        assert {k: v for k, v in g.items() if k != "surprisal"} == {k: v for k, v in w.items() if k != "surprisal"}
        assert g["surprisal"] == pytest.approx(w["surprisal"], abs=TOL, rel=TOL)
    assert any("%20(" in r["edit_link"] for r in got)

    # the command line: the MaiMod config (v32 under ``inference``), on the CPU by name, at the
    # default threshold; the same report as the JAX script's
    argv = [f"beatmap_path={osu}", f"audio_path={wav}", "raw_output=true", f"inference.model_path={ckpt}",
            "inference.seed=3", "inference.device=cpu", f"inference.train.data.src_seq_len={SRC_SEQ_LEN}",
            f"inference.train.data.tgt_seq_len={TGT_SEQ_LEN}"]
    reports = []
    for module in (jax_mai_mod, mai_mod):
        capsys.readouterr()
        by_category = module.main(argv)
        out = capsys.readouterr().out
        reports.append((by_category, out[out.index("The first value"):]))
    assert reports[1] == reports[0]
    assert f"Found {sum(r['surprisal'] >= 2.0 for r in got)} suggestions:" in reports[1][1]


def fallback_case(tmp_path, side: str, precision: str = "bf16"):
    """A taiko map under the v30 preset (gamemodes [0]), with the paths,
    precision and seed given: the arguments of ``select_config_for_gamemode``."""
    taiko = tmp_path / "taiko.osu"
    taiko.write_text(SIMPLE_OSU.replace("Mode: 0", "Mode: 1"))
    o = [f"beatmap_path={taiko}", f"audio_path={tmp_path / 'song.wav'}", f"output_path={tmp_path / 'out'}",
         f"precision={precision}", "seed=11", "cfg_scale=1.5"]
    if side == "jax":
        return compose(REPO_ROOT / "configs" / "inference", "v30", overrides=o, schema_cls=schema.InferenceConfig)
    return load_config("v30", o)


def test_gamemode_fallback_composes_the_jax_arguments(tmp_path):
    """The fallback to v31: the preset's gamemodes, the map's mode, the
    paths, precision and seed carried over, the command line's
    ``inference.*`` overrides re-applied and every other field v31's own,
    as the JAX function composes them; a mode the config covers keeps the
    arguments as they are."""
    overrides = ["inference.temperature=0.7", "inference.max_batch_size=2", "beatmap_path=ignored.osu"]
    want = jax_mai_mod.select_config_for_gamemode(fallback_case(tmp_path, "jax"), verbose=False, overrides=overrides)
    args = fallback_case(tmp_path, "torch")
    assert list(args.train.data.gamemodes) == [0]
    got = mai_mod.select_config_for_gamemode(args, verbose=False, overrides=overrides)
    assert got is not args
    assert config_plain(got, keep_enums=True) == config_plain(want, keep_enums=True)
    assert list(got.train.data.gamemodes) == [0, 1, 2, 3] and got.gamemode == 1
    assert (got.beatmap_path, got.precision, got.seed) == (args.beatmap_path, "bf16", 11)
    assert (got.temperature, got.max_batch_size, got.cfg_scale, got.version) == (0.7, 2, 1.0, "Mapperatorinator V31")
    covered = load_config("v32", [f"beatmap_path={args.beatmap_path}"])
    assert mai_mod.select_config_for_gamemode(covered, verbose=False) is covered


def test_run_analysis_falls_back_to_v31_with_the_jax_records(tmp_path, monkeypatch, jax_loads_cond):  # noqa: F811
    """``run_analysis`` on a taiko map under v30 composes v31 (the command
    line's ``inference.*`` overrides point it at a tiny v31 checkpoint and
    the CPU) and analyses the map with it: the JAX records, surprisals
    within the bar (in fp32: the precision carries over)."""
    ckpt = make_tiny_cond_checkpoint(tmp_path / "v31")
    make_wav(tmp_path / "song.wav", seconds=4.0)
    overrides = [f"inference.model_path={ckpt}", "inference.device=cpu",
                 f"inference.train.data.src_seq_len={SRC_SEQ_LEN}", f"inference.train.data.tgt_seq_len={COND_TGT_SEQ_LEN}"]
    records, fallbacks = [], []
    for module, side in ((jax_mai_mod, "jax"), (mai_mod, "torch")):
        select = module.select_config_for_gamemode

        def recorded(i_args, _select=select, **kw):
            fallbacks.append(_select(i_args, overrides=overrides, **kw))
            return fallbacks[-1]

        monkeypatch.setattr(module, "select_config_for_gamemode", recorded)
        records.append(module.run_analysis(fallback_case(tmp_path, side, "fp32"), surprisal_threshold=0.0))
    assert [(f.version, f.gamemode, f.model_path) for f in fallbacks] == [("Mapperatorinator V31", 1, str(ckpt))] * 2
    want, got = records
    assert len(got) == len(want) > 5
    for g, w in zip(got, want):
        assert {k: v for k, v in g.items() if k != "surprisal"} == {k: v for k, v in w.items() if k != "surprisal"}
        assert g["surprisal"] == pytest.approx(w["surprisal"], abs=TOL, rel=TOL)
