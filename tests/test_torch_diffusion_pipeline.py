"""The port's DiT refinement pipeline (``infer/diffusion_pipeline.py``) and
the JAX package's (``tests/test_torch_diffusion_generate.py`` runs it
inside ``inference.generate``).

The settings cut v32's chunks as
``tests/test_diffusion.py::test_pipeline_sequence_roundtrip`` does
(``max_seq_len`` 32, ``overlap_buffer`` 4), so a song of a few dozen hit
objects samples in several overlapping chunks, and its respacing from 100
steps to 4, ``timesteps [4, 0, ..., 0]``: like v32's ``[100, 0, ..., 0]``,
the steps come from the first tenth of the 1 000-step process. (That test's
``timesteps [4]`` over ``diffusion_steps`` 8 spans the whole process: its
last step multiplies eps by 163 in ``pred_xstart``, and over the loop the
random DiT's sensitivity to x, whose coordinates it embeds at x * 512,
grows the two frameworks' one-step differences of ~1e-6 to up to 9e-2;
under this schedule they stay below 1e-5, measured on these cases.) Both packages run tiny DiTs (hidden 32, depth 2,
2 heads, context 272, the 48 classes of ``DiffusionVocab.from_args`` on
the diffusion config) with the same weights, every leaf drawn from a seeded
normal. The events come from a map of circles and sliders of four curve
types with SV greenlines, parsed by the JAX parser (and handed to the port
by value), so the sliders' ends are in-painted each step (the host
round trip).

JAX draws from ``jax.random`` keys, which torch cannot reproduce. The port
takes the JAX draws through its keyed noise source: ``PRNGKey(seed)``, one
split for ``random_init``, one a chunk, then one a step along the chunk's
key (the DDPM steps, and the refine steps again from the chunk's key),
each step's key split into (noise, denoise) (``diffusion_pipeline.py:281-300``,
``gaussian.py:213-249``).

The sampled sequences must agree within 1e-4 (in [-1, 1] units), and the
rendered events be equal but for a coordinate 1 px off where the JAX value
lies within 0.05 px of a rounding tie.

Two faults of the JAX pipeline are worked around on its side, each on the
instance, and neither copied by the port (ROADMAP section 3); no JAX file
changes:

* it is built with ``vocab=DiffusionVocab.from_args(args.diffusion)``: its
  default, ``DiffusionVocab()``, has 0 classes and fits no bundle that
  ``diffusion_train.py`` exports; the port takes that vocabulary itself;
* its ``_slider_recompute_host`` is handed ``np.asarray(x)``: the installed
  JAX's ``jax.pure_callback`` passes the callback a ``jax.Array``, whose item
  assignment raises, so every chunk with an in-painted slider fails; the
  port's round trip hands it numpy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mapperatorinator_tpu.config import compose, schema
from mapperatorinator_tpu.diffusion.vocab import DiffusionVocab as JaxDiffusionVocab
from mapperatorinator_tpu.infer import diffusion_pipeline as jax_diffusion_pipeline
from mapperatorinator_tpu.infer.processor import GenerationConfig as JaxGenerationConfig
from mapperatorinator_tpu.osu import build_vocabulary as jax_build_vocabulary
from mapperatorinator_tpu.osu.beatmap import Beatmap as JaxBeatmap
from mapperatorinator_tpu.osu.parsing import BeatmapParser as JaxBeatmapParser
from mapperatorinator_tpu_torch.config import load_config
from mapperatorinator_tpu_torch.infer.diffusion_pipeline import PLAYFIELD, DiffusionPipeline
from mapperatorinator_tpu_torch.infer.processor import GenerationConfig
from mapperatorinator_tpu_torch.osu.beatmap import Beatmap
from mapperatorinator_tpu_torch.osu.events import Event, EventType
from tests.fixtures.tiny_checkpoint import REPO_ROOT
from tests.test_torch_dit import jax_model

JaxDiffusionPipeline = jax_diffusion_pipeline.DiffusionPipeline

CUT = ["max_seq_len=32", "overlap_buffer=4", "timesteps=[4,0,0,0,0,0,0,0,0,0]", "seed=3"]
SAMPLE_TOL = 1e-4
TIE_PX = 0.05

MAP_HEAD = """osu file format v14

[General]
AudioFilename: audio.mp3
Mode: 0

[Metadata]
Title:DiT
Artist:pytest
Creator:parity
Version:dit
BeatmapID:1
BeatmapSetID:1

[Difficulty]
HPDrainRate:5
CircleSize:4
OverallDifficulty:8
ApproachRate:9
SliderMultiplier:1.4
SliderTickRate:1

[TimingPoints]
0,500,4,2,0,60,1,0
{greens}

[HitObjects]
{objects}
"""


def make_map(path, n_objects, seed=0, step=250):
    """Circles and sliders (Bezier, perfect, linear, Catmull; 1 or 2 slides)
    from 500 ms on, each slider under a greenline of its own SV."""
    rng = np.random.default_rng(seed)
    objects, greens, t = [], [], 500
    for i in range(n_objects):
        x, y = int(rng.integers(32, 480)), int(rng.integers(32, 352))
        nc = 4 if i % 4 == 0 else 0
        kind = rng.choice(["circle", "B", "P", "L", "C"], p=[0.5, 0.2, 0.1, 0.1, 0.1])
        if kind == "circle":
            objects.append(f"{x},{y},{t},{1 | nc},0,0:0:0:0:")
            t += step
            continue
        points = [(int(np.clip(x + rng.integers(-80, 80), 0, 512)), int(np.clip(y + rng.integers(-80, 80), 0, 384)))
                  for _ in range({"B": 3, "P": 2, "L": 1, "C": 3}[kind])]
        slides = int(rng.choice([1, 1, 2]))
        greens.append(f"{t},{-100 / float(rng.choice([1.0, 0.75, 1.5])):.4f},4,2,0,60,0,0")
        objects.append(f"{x},{y},{t},{2 | nc},0,{kind}|" + "|".join(f"{a}:{b}" for a, b in points)
                       + f",{slides},{60 + 20 * int(rng.integers(0, 4))}")
        t += 2 * step * slides
    path.write_text(MAP_HEAD.format(greens="\n".join(greens), objects="\n".join(objects)), encoding="utf-8")
    return path


def jax_noise(seed, random_init, n_steps):
    """The port's keyed noise source, giving the draws of the JAX pipeline's
    key tree."""

    def noise(shape, where):
        rng = jax.random.PRNGKey(seed)
        if random_init:
            rng, sub = jax.random.split(rng)
            if where[0] == "init":
                return np.asarray(jax.random.normal(sub, shape, jnp.float32))
        _, chunk, k = where
        for _ in range(chunk + 1):
            rng, sub = jax.random.split(rng)
        key = sub  # the chunk's key: its DDPM steps split along it, then its refine steps again from it
        for _ in range(k - n_steps if k >= n_steps else k):
            key, _ = jax.random.split(key)
        _, step = jax.random.split(key)
        return np.asarray(jax.random.normal(jax.random.split(step)[0], shape, jnp.float32))

    return noise


def models(refine: bool):
    """(JAX bundle, JAX refine bundle, port DiT, port refine DiT), each
    pair with the same weights."""
    out = []
    for seed in (0, 1)[: 1 + refine]:
        model, port, params = jax_model(context_size=272, class_size=48, seed=seed)
        out.append(((model, params), port))
    (jax_bundle, port_model), *rest = out
    jax_refine, port_refine = rest[0] if rest else (None, None)
    return jax_bundle, jax_refine, port_model, port_refine


def jax_pipeline(args, model, refine):
    """The JAX pipeline with both workarounds of the module docstring."""
    pipeline = JaxDiffusionPipeline(args, model, refine, vocab=JaxDiffusionVocab.from_args(args.diffusion))
    recompute = pipeline._slider_recompute_host
    pipeline._slider_recompute_host = lambda x: recompute(np.asarray(x))
    return pipeline


def to_port(events):
    return [Event(EventType(e.type.value), e.value) for e in events]


def capture_full(pipeline, sink):
    """Record the sampled sequence each ``generate`` turns into positions."""
    to_positions = pipeline._to_positions
    pipeline._to_positions = lambda full: (sink.append(np.array(full)), to_positions(full))[1]


def assert_same_positions(got_events, want_events, want_full, seq_indices):
    """Equal events, but a coordinate may be 1 px off where the JAX value
    lies within TIE_PX of a rounding tie."""
    assert [e.type.value for e in got_events] == [e.type.value for e in want_events]
    positions = (want_full[0] + 1) / 2 * PLAYFIELD
    off = 0
    for i, (got, want) in enumerate(zip(got_events, want_events)):
        if got.value == want.value:
            continue
        axis = {"pos_x": 0, "pos_y": 1}[want.type.value]
        value = positions[seq_indices[i], axis]
        assert abs(got.value - want.value) == 1 and abs(abs(value - np.floor(value)) - 0.5) < TIE_PX, (i, got, want)
        off += 1
    return off


CASES = {  # (config, overrides, refine)
    "v31-chunks-sliders-refine": ("v31", ["refine_iters=2"], True),
    "v31-random-init": ("v31", ["random_init=true"], False),
    "v31-start-end-time": ("v31", ["start_time=4000", "end_time=9000", "refine_iters=2"], True),
    "v32-pos-tokens": ("v32", [], False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_pipeline_matches_jax_given_the_jax_draws(tmp_path, case):
    name, extra, refine = CASES[case]
    jax_args = compose(REPO_ROOT / "configs" / "inference", name, schema_cls=schema.InferenceConfig,
                       overrides=[*CUT, *extra])
    args = load_config(name, [*CUT, *extra])
    source = JaxBeatmap.from_path(make_map(tmp_path / "map.osu", 24))
    jax_events, _ = JaxBeatmapParser(jax_args.train, jax_build_vocabulary(jax_args.train)).parse(source)
    events = to_port(jax_events)
    jax_timing = [tp for tp in source.timing_points if tp.parent is None]
    timing = [tp for tp in Beatmap.from_path(tmp_path / "map.osu").timing_points if tp.parent is None]

    jax_bundle, jax_refine, port_model, port_refine = models(refine)
    want_pipe = jax_pipeline(jax_args, jax_bundle, jax_refine)
    n_steps = want_pipe._get_diffusion().num_timesteps
    got_pipe = DiffusionPipeline(args, port_model, port_refine, noise=jax_noise(3, args.random_init, n_steps))
    want_full, got_full = [], []
    capture_full(want_pipe, want_full)
    capture_full(got_pipe, got_full)

    want = want_pipe.generate(jax_events, JaxGenerationConfig(difficulty=5.5, circle_size=4.0), jax_timing)
    got = got_pipe.generate(events, GenerationConfig(difficulty=5.5, circle_size=4.0), timing)

    seq_x, seq_o, _, seq_len, seq_indices, sliders = got_pipe.events_to_sequence(events, timing, 1.4)
    stride = args.max_seq_len - 2 * args.overlap_buffer
    assert len(range(0, seq_len - 2 * args.overlap_buffer, stride)) >= 3 and len(sliders) >= 5
    np.testing.assert_allclose(got_full[0], want_full[0], rtol=0, atol=SAMPLE_TOL)
    assert_same_positions(got, want, want_full[0], seq_indices)
    assert np.abs(want_full[0][0] - seq_x).max() > 0.1  # the positions were sampled anew
    if args.start_time is not None:
        # outside [start_time, end_time] the positions are kept, slider ends
        # aside (the in-paint recomputes every slider of a chunk)
        kept = (seq_o < args.start_time) | (seq_o > args.end_time)
        kept[[s.end_index for s in sliders]] = False
        np.testing.assert_allclose(got_full[0][0][kept], seq_x[kept], rtol=0, atol=1e-6)


def test_the_pipeline_refuses_a_bundle_of_another_vocabulary():
    args = load_config("v32", CUT)
    _, port, _ = jax_model(context_size=272, class_size=47)
    with pytest.raises(ValueError, match="48 classes"):
        DiffusionPipeline(args, port)
