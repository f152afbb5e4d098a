"""The separate timing model on the port: a checkpoint directory with a
``gamemode=1`` fine-tune beside its base checkpoint. ``inference.main`` with
``gamemode=1`` serves the fine-tune and, since timing must be generated,
loads the base checkpoint for the timing pass
(``should_load_separate_timing_model``); the .osu must equal the JAX
package's from the same directory.
"""

import torch

import inference as jax_inference
from mapperatorinator_tpu_torch import inference
from mapperatorinator_tpu_torch.config import load_config
from mapperatorinator_tpu_torch.models.io import load_checkpoint
from tests.fixtures.tiny_checkpoint import SRC_SEQ_LEN, make_tiny_checkpoint, make_wav

torch.set_num_threads(1)


def test_timing_comes_from_the_base_checkpoint(tmp_path, monkeypatch):
    base = make_tiny_checkpoint(tmp_path / "ckpt", seed=0)
    tuned = make_tiny_checkpoint(tmp_path / "ckpt" / "gamemode=1", seed=1)
    wav = make_wav(tmp_path / "song.wav", seconds=3.0)
    overrides = [f"model_path={base}", f"audio_path={wav}", f"train.data.src_seq_len={SRC_SEQ_LEN}",
                 "train.data.tgt_seq_len=128", "do_sample=false", "seed=7", "gamemode=1", "difficulty=4.5",
                 "title=TimingModel", "bpm=120", "offset=0", "device=cpu"]
    assert inference.should_load_separate_timing_model(load_config("v32", overrides))
    assert not inference.should_load_separate_timing_model(load_config("v32", [*overrides, "gamemode=0"]))

    loaded, decoded = [], []
    load = inference.load_model

    def recording(args, auto_select_gamemode_model=None):
        engine, vocab = load(args, auto_select_gamemode_model)
        loaded.append(engine)
        generate = engine.generate

        def counted(*a, **kw):
            decoded.append(engine)
            return generate(*a, **kw)

        engine.generate = counted
        return engine, vocab

    monkeypatch.setattr(inference, "load_model", recording)
    texts = []
    for module in (jax_inference, inference):
        out = tmp_path / module.__name__
        out.mkdir()
        texts.append(module.main(["-cn", "v32", *overrides, f"output_path={out}"])[0])

    assert len(loaded) == 2
    for engine, directory in zip(loaded, (tuned, base)):  # the served model, then the timing model
        want = load_checkpoint(directory)[0].state_dict()
        assert all(torch.equal(t, want[n]) for n, t in engine.model.state_dict().items())
    # the timing pass decodes every window on the base model first, then the map on the fine-tune
    served, timing = loaded
    first_served = decoded.index(served)
    assert first_served > 0 and set(decoded[:first_served]) == {timing} and set(decoded[first_served:]) == {served}
    assert texts[1] == texts[0] and "Mode: 1" in texts[1]
