"""The whole DiT slice: each package's ``inference.generate`` under ``-cn
v31`` with ``generate_positions=true``, on the same scripted tokens (the
Processor harness of ``tests/test_torch_processor_scripted.py``, fed the
tokens of ``tests/test_torch_diffusion_pipeline.py``'s slider map), with a
DiT and a refine DiT of the same weights in both and the JAX draws given to
the port, must write the same .osu bytes. v31 writes positions as DISTANCE
and POS_X / POS_Y events, which the pipeline replaces; v32's POS tokens it
leaves as they are (``events_with_pos``, in both packages).

The JAX side runs with the workarounds of the pipeline test (its vocabulary
and its slider callback's input), patched on the instance that its
``generate`` builds; no JAX file changes.
"""

import functools

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
from mapperatorinator_tpu_torch.osu import build_vocabulary
from mapperatorinator_tpu_torch.osu.beatmap import Beatmap
from tests.fixtures.tiny_checkpoint import REPO_ROOT, make_wav
from tests.test_e2e_osu_parity import _window_scripts
from tests.test_torch_diffusion_pipeline import CUT, jax_noise, jax_pipeline, make_map, models
from tests.test_torch_processor_scripted import scripted


def test_generate_with_generate_positions_writes_the_jax_osu(tmp_path, monkeypatch):
    """The whole slice: each package's ``inference.generate`` under ``-cn v31``
    with ``generate_positions=true`` on the same scripted tokens (the
    Processor harness of ``tests/test_torch_processor_scripted.py``, the
    tokens of the slider map above), the DiT and a refine DiT with the same
    weights, the port given the JAX draws: the same .osu bytes."""
    wav = make_wav(tmp_path / "song.wav", seconds=10.0)
    for side in ("jax", "torch"):
        (tmp_path / side).mkdir()
    given = [f"audio_path={wav}", "train.data.src_seq_len=256", "train.data.tgt_seq_len=192", "gamemode=0",
             "difficulty=4.5", "do_sample=false", "parallel=false", "title=DiT", "artist=pytest", "creator=parity",
             "version=dit", "bpm=120", "offset=0", "device=cpu", "generate_positions=true", "refine_iters=2", *CUT]
    jax_args = compose(REPO_ROOT / "configs" / "inference", "v31", schema_cls=schema.InferenceConfig,
                       overrides=[*given, f"output_path={tmp_path / 'jax'}"])
    args = load_config("v31", [*given, f"output_path={tmp_path / 'torch'}"])
    jax_vocab, vocab = jax_build_vocabulary(jax_args.train), build_vocabulary(args.train)

    pre = JaxPreprocessor(jax_args)
    frame_times = [int(t) for t in pre.segment(pre.load(str(wav)))[1]]
    source = JaxBeatmap.from_path(make_map(tmp_path / "map.osu", 24))
    parser = JaxBeatmapParser(jax_args.train, jax_vocab)
    scripts = {"timing": _window_scripts(*parser.parse_timing(source), jax_vocab, frame_times),
               "map": _window_scripts(*parser.parse(source), jax_vocab, frame_times)}
    monkeypatch.setattr(JaxProcessor, "model_generate", scripted([], scripts, jax_vocab.eos_id))
    monkeypatch.setattr(Processor, "model_generate", scripted([], scripts, vocab.eos_id))

    jax_bundle, jax_refine, port_model, port_refine = models(refine=True)
    pipelines = []
    monkeypatch.setattr(jax_diffusion_pipeline, "DiffusionPipeline",
                        lambda *a: pipelines.append(jax_pipeline(*a)) or pipelines[-1])
    monkeypatch.setattr(inference, "DiffusionPipeline", functools.partial(
        DiffusionPipeline, noise=jax_noise(3, False, 4)))

    results = []
    for module, a, v, diff, ref in ((jax_inference, jax_args, jax_vocab, jax_bundle, jax_refine),
                                    (inference, args, vocab, port_model, port_refine)):
        module.compile_args(a, v, verbose=False)
        generation_config, beatmap_config = module.get_config(a)
        results.append(module.generate(a, generation_config=generation_config, beatmap_config=beatmap_config,
                                       engine=None, vocab=v, verbose=False, diff_model=diff, refine_model=ref))
    (want, want_path), (got, got_path) = results
    assert len(pipelines) == 1  # the JAX side refined too
    assert got_path.read_bytes() == want_path.read_bytes()
    beatmap = Beatmap.from_path(got_path)
    assert len(beatmap.hit_objects()) >= 10
    placed = {(h.x, h.y) for h in beatmap.hit_objects()}
    assert not placed <= {(h.x, h.y) for h in JaxBeatmap.from_path(tmp_path / "map.osu").hit_objects()}
