"""Checkpoint path resolution of the JAX ``models/lora.py``: a
``gamemode=N`` fine-tune subfolder of a checkpoint is preferred when it
exists. The definitions below are copies of the JAX package's;
``tests/test_torch_nojax.py`` holds them to their source. LoRA adapters
themselves are not ported yet (ROADMAP queue 1, item 15).
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Optional

_GAMEMODE_SUBFOLDER_PATTERN = re.compile(r"gamemode=\d+")


def get_model_checkpoint_subfolder(ckpt_path) -> str:
    """'gamemode=N' component of a checkpoint path, if any
    (reference: model_utils.py:215-229)."""
    if not ckpt_path:
        return ""
    for part in str(ckpt_path).replace("\\", "/").split("/"):
        if _GAMEMODE_SUBFOLDER_PATTERN.fullmatch(part):
            return part
    return ""


def resolve_model_checkpoint_path(ckpt_path, gamemode: Optional[int] = None,
                                  auto_select_gamemode_model: bool = True):
    """Prefer a ``gamemode=N`` fine-tune subfolder when it exists
    (reference: model_utils.py:269-301)."""
    if not ckpt_path or gamemode is None or not auto_select_gamemode_model:
        return ckpt_path
    gamemode_path = Path(ckpt_path) / f"gamemode={gamemode}"
    if gamemode_path.is_dir():
        return gamemode_path
    return ckpt_path
