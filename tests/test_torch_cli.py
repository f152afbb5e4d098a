"""The port's command line, ``python -m mapperatorinator_tpu_torch.inference``:
``main`` on the tiny checkpoint and a synthesized WAV writes the .osu of the
API path (``load_model`` / ``generate``), with fp32 and with int8 weights and
KV cache, and refuses what is not ported, naming its ROADMAP item (LoRA
adapters, ``lora_path``, are covered by ``tests/test_torch_lora.py``);
``generate_positions=true`` with no DiT bundle on disk writes the same .osu;
``-cn v32`` on a published T5 v1.1, NWhisper or moonshine checkpoint
(moonshine with int8 weights and KV) writes the .osu bytes of the JAX
package's command line.
"""

import pytest
import torch

import inference as jax_inference
from mapperatorinator_tpu_torch import inference
from mapperatorinator_tpu_torch.config import load_config
from mapperatorinator_tpu_torch.models.transformer import QDense
from tests.fixtures.tiny_checkpoint import SRC_SEQ_LEN, TGT_SEQ_LEN, make_wav
from tests.test_torch_convert import FAMILY_OVERRIDES, SRC_LEN, TGT_LEN, write_hf_checkpoint
from tests.test_torch_model import tiny  # noqa: F401  (module fixture)

torch.set_num_threads(1)


@pytest.mark.parametrize("int8", [False, True])
def test_cli_main_writes_the_api_osu(tiny, tmp_path, int8):  # noqa: F811
    wav = make_wav(tmp_path / "song.wav", seconds=3.0)
    overrides = [f"model_path={tiny[0]}", f"audio_path={wav}", f"train.data.src_seq_len={SRC_SEQ_LEN}",
                 f"train.data.tgt_seq_len={TGT_SEQ_LEN}", "do_sample=false", "seed=7", "gamemode=0", "device=cpu",
                 "title=TinyFixture", "bpm=120", "offset=0",
                 f"quantized_weights={str(int8).lower()}", f"quantized_kv={str(int8).lower()}"]
    (tmp_path / "cli").mkdir()
    (tmp_path / "api").mkdir()
    text, path = inference.main(["-cn", "v32", *overrides, f"output_path={tmp_path / 'cli'}"])
    args = load_config("v32", [*overrides, f"output_path={tmp_path / 'api'}"])
    engine, vocab = inference.load_model(args)
    assert engine.model.cfg.backbone.quantized_kv == int8
    assert any(isinstance(m, QDense) for m in engine.model.modules()) == int8
    inference.compile_args(args, vocab, verbose=False)
    generation_config, beatmap_config = inference.get_config(args)
    want, want_path = inference.generate(args, generation_config=generation_config, beatmap_config=beatmap_config,
                                         engine=engine, vocab=vocab, verbose=False)
    assert path.parent == tmp_path / "cli" and "[HitObjects]" in text
    assert text == want and path.read_bytes() == want_path.read_bytes()


def test_cli_refuses_what_is_not_ported(tmp_path):
    """A backbone of no family the port builds (the JAX package would build
    it as a VarWhisper of the name's size). (DiT refinement, v28's
    whisper-base, T5, NWhisper and moonshine, which this refused before, are
    ported: ``tests/test_torch_diffusion_generate.py``,
    ``tests/test_torch_whisper_abs_serving.py``, ``tests/test_torch_t5.py``,
    and the two tests below.)"""
    wav = make_wav(tmp_path / "song.wav", seconds=1.0)
    base = ["model_path=", f"audio_path={wav}", f"output_path={tmp_path}", "device=cpu", "gamemode=0"]
    for name in ("facebook/bart-base", "openai/clap-small"):
        with pytest.raises(NotImplementedError, match="the port builds"):
            inference.main(["-cn", "v32", *base, f"train.model.name={name}"])


def test_cli_generate_positions_without_a_bundle_keeps_the_positions(tiny, tmp_path, capsys):  # noqa: F811
    """``generate_positions=true`` with ``diff_ckpt`` naming no bundle (v32's
    default names the published one, which is not on disk): the message of
    the JAX ``inference.py``, and the .osu of a run without the option."""
    wav = make_wav(tmp_path / "song.wav", seconds=3.0)
    base = [f"model_path={tiny[0]}", f"audio_path={wav}", f"train.data.src_seq_len={SRC_SEQ_LEN}",
            f"train.data.tgt_seq_len={TGT_SEQ_LEN}", "do_sample=false", "seed=7", "gamemode=0", "device=cpu",
            "title=TinyFixture", "bpm=120", "offset=0"]
    texts = []
    for option in ("false", "true"):
        (tmp_path / option).mkdir()
        texts.append(inference.main(["-cn", "v32", *base, f"output_path={tmp_path / option}",
                                     f"generate_positions={option}"])[0])
    assert "diffusion checkpoint 'OliBomby/osu-diffusion-v2' not found; positions stay as generated" \
        in capsys.readouterr().out
    assert texts[1] == texts[0] and "[HitObjects]" in texts[0]


def cli_osu_of_both_packages(tmp_path, family: str, title: str, extra=()):
    """``-cn v32 model_path=<HF dir of family>``, greedy, through the JAX
    package's ``main`` and the port's: (text, bytes) of each .osu (the
    model's own config.json decides the backbone; v32 decides the windows
    and prompts)."""
    directory, _, _ = write_hf_checkpoint(tmp_path / family, "v32", overrides=FAMILY_OVERRIDES[family])
    wav = make_wav(tmp_path / "song.wav", seconds=2.0)
    base = [f"model_path={directory}", f"audio_path={wav}", f"train.data.src_seq_len={SRC_LEN}",
            f"train.data.tgt_seq_len={TGT_LEN}", "do_sample=false", "seed=7", "gamemode=0", "device=cpu",
            "super_timing=false", f"title={title}", "bpm=120", "offset=0", *extra]
    written = []
    for name, main in (("jax", jax_inference.main), ("port", inference.main)):
        (tmp_path / name).mkdir()
        text, path = main(["-cn", "v32", *base, f"output_path={tmp_path / name}"])
        written.append((text, path.read_bytes()))
    return written


def test_cli_on_a_t5_checkpoint_writes_the_jax_clis_osu(tmp_path):
    """``-cn v32 model_path=<HF T5 dir>``: the same .osu bytes."""
    (want, want_bytes), (got, got_bytes) = cli_osu_of_both_packages(tmp_path, "t5", "T5")
    assert "[HitObjects]" in got and "Title:T5" in got
    assert got == want and got_bytes == want_bytes


def test_cli_on_an_nwhisper_checkpoint_writes_the_jax_clis_osu(tmp_path):
    """``-cn v32 model_path=<HF NWhisper dir>``: the same .osu bytes."""
    (want, want_bytes), (got, got_bytes) = cli_osu_of_both_packages(tmp_path, "nwhisper", "NWhisper")
    assert "[HitObjects]" in got and "Title:NWhisper" in got
    assert got == want and got_bytes == want_bytes


def test_cli_on_a_moonshine_checkpoint_writes_the_jax_clis_osu(tmp_path):
    """``-cn v32 model_path=<HF moonshine dir>``, raw samples into the
    backbone, with int8 weights and KV on both sides: the same .osu bytes."""
    (want, want_bytes), (got, got_bytes) = cli_osu_of_both_packages(
        tmp_path, "moonshine", "Moonshine", ("quantized_weights=true", "quantized_kv=true"))
    assert "[HitObjects]" in got and "Title:Moonshine" in got
    assert got == want and got_bytes == want_bytes
