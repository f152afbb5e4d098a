"""The whole v32 generation path, audio to .osu, on the port against the JAX
package: the repo's ``inference.generate`` (the JAX Processor and Renderer)
and ``mapperatorinator_tpu_torch.inference.generate`` run greedy decode on the
tiny checkpoint and a synthesized WAV with short windows, on the CPU by
name. The events handed to each package's renderer must be equal and the .osu
text byte-equal. Each package composes the config its own way (the JAX loader;
the port's checked-in JSON) from the same overrides.
"""

import numpy as np
import pytest

import inference as jax_inference
from mapperatorinator_tpu.config import compose, schema
from mapperatorinator_tpu.osu import rendering
from mapperatorinator_tpu_torch import inference
from mapperatorinator_tpu_torch.config import load_config
from mapperatorinator_tpu_torch.osu import rendering as port_rendering
from tests.fixtures.tiny_checkpoint import REPO_ROOT, SRC_SEQ_LEN, TGT_SEQ_LEN, make_wav
from tests.test_torch_model import tiny  # noqa: F401  (module fixture)


def run(module, directory, wav, out, gamemode):
    overrides = [
        f"model_path={directory}", f"audio_path={wav}", f"output_path={out}",
        f"train.data.src_seq_len={SRC_SEQ_LEN}", f"train.data.tgt_seq_len={TGT_SEQ_LEN}",
        "do_sample=false", "seed=7", f"gamemode={gamemode}", "difficulty=4.5",
        "title=TinyFixture", "artist=pytest", "creator=ci", "version=e2e", "bpm=120", "offset=0", "device=cpu",
    ]
    if module is jax_inference:
        args = compose(REPO_ROOT / "configs" / "inference", "v32", schema_cls=schema.InferenceConfig,
                       overrides=overrides)
    else:
        args = load_config("v32", overrides)
    engine, vocab = module.load_model(args)
    module.compile_args(args, vocab, verbose=False)
    generation_config, beatmap_config = module.get_config(args)
    return module.generate(args, generation_config=generation_config, beatmap_config=beatmap_config,
                           engine=engine, vocab=vocab, verbose=False)


@pytest.mark.parametrize("gamemode", [0, 3])
def test_port_writes_the_jax_osu(tiny, tmp_path, monkeypatch, gamemode):  # noqa: F811
    directory = tiny[0]
    wav = make_wav(tmp_path / "song.wav", seconds=3.0)
    rendered = []

    def recording(renderer_cls):
        render = renderer_cls.generate

        def generate(self, events, **kw):
            rendered.append([(e.type.value, e.value) for e in events or []])
            return render(self, events=events, **kw)
        return generate

    for module in (rendering, port_rendering):
        monkeypatch.setattr(module.Renderer, "generate", recording(module.Renderer))
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    want, want_path = run(jax_inference, directory, wav, tmp_path / "jax", gamemode)
    got, got_path = run(inference, directory, wav, tmp_path / "torch", gamemode)

    assert len(rendered) == 2 and len(rendered[0]) > 0
    assert rendered[1] == rendered[0]
    assert got == want
    assert got_path.read_bytes() == want_path.read_bytes()
    assert np.any([line.startswith("Mode: " + str(gamemode)) for line in got.splitlines()])
