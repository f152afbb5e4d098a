"""The port's interactive wizard, ``mapperatorinator_tpu_torch/cli_inference.sh``,
against the repo's ``cli_inference.sh``: the same scripted answers through
both, with a stand-in ``python`` first on ``PATH`` that records its
arguments, must give the same command line, the JAX CLI's ``inference.py``
swapped for ``-m mapperatorinator_tpu_torch.inference``. The port's preset
menu comes from ``configs/inference/*.yaml`` and matches the JAX wizard's.
"""

import os
import stat
import subprocess

import pytest

from tests.fixtures.tiny_checkpoint import REPO_ROOT

PORT_WIZARD = REPO_ROOT / "mapperatorinator_tpu_torch" / "cli_inference.sh"
JAX_WIZARD = REPO_ROOT / "cli_inference.sh"

# one answer a prompt, in the wizard's order (an empty line takes the default)
DEFAULTS = ["", "", "", "", "",  # preset (v32), model path, LoRA path, bf16, server
            "song.mp3", "", "",  # audio, output directory, reference beatmap
            "", "", "", "", "",  # gamemode (standard), difficulty, mapper, year, hitsounds
            "", "", "", "", "", "",  # HP, CS, OD, AR, slider multiplier, tick rate
            "", "",  # descriptors, negative descriptors
            "", "", "", "", "", "",  # CFG, temperature, top-p, seed, super timing, positions
            "", "",  # start, end
            "", "", "", "", "", "", "", "",  # title, artist, creator, version, source, tags, background, .osz
            "y"]  # run it now
MANIA = ["2", "ckpt dir/", "lora", "n", "y",  # v29, a path with a space, LoRA, fp32, server
         "song.ogg", "out", "ref.osu",
         "4", "5.5", "1234", "2019", "n",  # mania, difficulty, mapper, year, no hitsounds
         "7", "4", "8", "9", "1.4", "1",
         "7", "0.3", "0.8",  # keycount, hold note ratio, scroll speed ratio (mania asks all three)
         "clean, tech ,  jumps", "messy",
         "2.5", "0.7", "0.95", "42", "y", "y",
         "y", "n", "y", "y", "y", "n",  # contexts: timing, not GD, kiai, sv; into the reference, not overwriting
         "1000", "60000",
         "Title: Sub", "Artist", "me", "Insane", "src", "a b", "bg.png", "y",
         "n"]  # print only


@pytest.fixture
def recorded(tmp_path):
    """Runs a wizard with scripted answers and a stand-in python; returns
    the arguments python was started with (None where it was not)."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    log = tmp_path / "argv"
    python = bin_dir / "python"
    python.write_text(f'#!/bin/bash\nprintf "%s\\n" "$@" > {log}\n')
    python.chmod(python.stat().st_mode | stat.S_IXUSR)

    def run(wizard, answers):
        log.unlink(missing_ok=True)
        proc = subprocess.run(["bash", str(wizard)], input="\n".join(answers) + "\n", capture_output=True, text=True,
                              timeout=60, env={**os.environ, "PATH": f"{bin_dir}{os.pathsep}{os.environ['PATH']}"})
        assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
        return (log.read_text().splitlines() if log.exists() else None), proc.stdout

    return run


@pytest.mark.parametrize("answers", [DEFAULTS, MANIA], ids=["defaults", "mania-with-reference"])
def test_the_command_line_is_the_jax_wizards(recorded, answers):
    want, want_out = recorded(JAX_WIZARD, answers)
    got, got_out = recorded(PORT_WIZARD, answers)
    module = ["-m", "mapperatorinator_tpu_torch.inference"]
    if answers is DEFAULTS:  # run: python received the command
        assert want[0] == "inference.py" and got[:2] == module and got[2:] == want[1:]
        assert got[2:4] == ["-cn", "v32"] and "audio_path=song.mp3" in got
    else:  # printed only
        assert want is None and got is None
    command = [line for line in want_out.splitlines() if "inference.py -cn" in line]
    assert [line.replace("python inference.py", "python " + " ".join(module)) for line in command] == \
        [line for line in got_out.splitlines() if "inference -cn" in line] != []


def test_the_preset_menu_is_configs_inference():
    """Choice N picks the same preset in both wizards."""
    presets = sorted((p.stem for p in (REPO_ROOT / "configs" / "inference").glob("*.yaml") if p.stem != "default"),
                     key=lambda s: s.encode() + b".yaml")
    jax_menu = "v28 v29 v30 v31 v32-mini v32".split()
    assert presets == jax_menu
    for i, name in enumerate(presets, 1):
        answers = [str(i), *DEFAULTS[1:-1], "n"]
        out = subprocess.run(["bash", str(PORT_WIZARD)], input="\n".join(answers) + "\n", capture_output=True,
                             text=True, timeout=60).stdout
        assert f"  {i}) {name}" in out and f"mapperatorinator_tpu_torch.inference -cn {name} " in out
