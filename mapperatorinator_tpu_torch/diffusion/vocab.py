"""Class-vector vocabulary for the DiT conditioning input: a copy of the JAX
``diffusion/vocab.py`` (``tests/test_torch_nojax.py`` holds it to its source).

One-hot layout [style | difficulty | mapper | descriptors | circle size]
(reference: ``osu_diffusion/utils/tokenizer.py:11-125``). Serialized lookup
tables load from a reference-format pickle/JSON or stay empty (unknown ids
fall back to the *_unk slots).
"""

from __future__ import annotations

import json
import pickle
from pathlib import Path
from typing import Optional

import numpy as np


class DiffusionVocab:
    def __init__(
        self,
        num_classes: int = 0,
        num_diff_classes: int = 0,
        max_difficulty: float = 0,
        num_mapper_classes: int = 0,
        num_descriptor_classes: int = 0,
        num_cs_classes: int = 0,
        beatmap_idx: Optional[dict] = None,
        beatmap_mapper: Optional[dict] = None,
        mapper_idx: Optional[dict] = None,
        beatmap_descriptors: Optional[dict] = None,
        descriptor_idx: Optional[dict] = None,
    ):
        self.num_classes = num_classes
        self.num_diff_classes = num_diff_classes
        self.max_difficulty = max_difficulty
        self.num_mapper_classes = num_mapper_classes
        self.num_descriptor_classes = num_descriptor_classes
        self.num_cs_classes = num_cs_classes
        self.beatmap_idx = beatmap_idx or {}
        self.beatmap_mapper = beatmap_mapper or {}
        self.mapper_idx = mapper_idx or {}
        self.beatmap_descriptors = beatmap_descriptors or {}
        self.descriptor_idx = descriptor_idx or {}

    @classmethod
    def from_args(cls, args) -> "DiffusionVocab":
        data = args.data
        return cls(
            num_diff_classes=data.num_diff_classes if data.difficulty_class else 0,
            max_difficulty=data.max_diff if data.difficulty_class else 0,
            num_cs_classes=data.num_cs_classes if data.circle_size_class else 0,
        )

    # -- encoders -----------------------------------------------------------------

    def encode_style(self, beatmap_id: int) -> int:
        return self.beatmap_idx.get(beatmap_id, self.num_classes - 1)

    @property
    def style_unk(self) -> int:
        return self.num_classes - 1

    def encode_diff(self, diff: float) -> int:
        return self.num_classes + int(
            np.clip(int(diff * (self.num_diff_classes - 2) / self.max_difficulty), 0, self.num_diff_classes - 2)
        )

    @property
    def diff_unk(self) -> int:
        return self.num_classes + self.num_diff_classes - 1

    def encode_mapper(self, user_id: int) -> int:
        mapper_idx = self.mapper_idx.get(user_id, self.num_mapper_classes - 1)
        return self.num_classes + self.num_diff_classes + mapper_idx

    @property
    def mapper_unk(self) -> int:
        return self.num_classes + self.num_diff_classes + self.num_mapper_classes - 1

    def encode_descriptor_name(self, descriptor: str) -> int:
        idx = self.descriptor_idx.get(descriptor, self.num_descriptor_classes)
        return self.num_classes + self.num_diff_classes + self.num_mapper_classes + idx

    @property
    def descriptor_unk(self) -> int:
        return self.num_classes + self.num_diff_classes + self.num_mapper_classes + self.num_descriptor_classes - 1

    def encode_cs(self, cs: float) -> int:
        base = self.num_classes + self.num_diff_classes + self.num_mapper_classes + self.num_descriptor_classes
        return base + int(np.clip(int(cs * (self.num_cs_classes - 2) / 10), 0, self.num_cs_classes - 2))

    @property
    def cs_unk(self) -> int:
        return (
            self.num_classes + self.num_diff_classes + self.num_mapper_classes
            + self.num_descriptor_classes + self.num_cs_classes - 1
        )

    @property
    def num_tokens(self) -> int:
        return (
            self.num_classes + self.num_diff_classes + self.num_mapper_classes
            + self.num_descriptor_classes + self.num_cs_classes
        )

    # -- serialization ----------------------------------------------------------------

    def state_dict(self) -> dict:
        return {
            "num_classes": self.num_classes,
            "num_diff_classes": self.num_diff_classes,
            "max_difficulty": self.max_difficulty,
            "num_mapper_classes": self.num_mapper_classes,
            "num_descriptor_classes": self.num_descriptor_classes,
            "num_cs_classes": self.num_cs_classes,
            "beatmap_idx": self.beatmap_idx,
            "beatmap_mapper": self.beatmap_mapper,
            "mapper_idx": self.mapper_idx,
            "beatmap_descriptors": self.beatmap_descriptors,
            "descriptor_idx": self.descriptor_idx,
        }

    @classmethod
    def from_state_dict(cls, sd: dict) -> "DiffusionVocab":
        return cls(**sd)

    @classmethod
    def from_pretrained(cls, path) -> "DiffusionVocab":
        path = Path(path)
        if path.is_dir():
            for name in ("diffusion_tokenizer.json", "tokenizer.json"):
                if (path / name).exists():
                    path = path / name
                    break
        if path.suffix == ".pkl" or path.suffix == ".pickle":
            with open(path, "rb") as f:
                return cls.from_state_dict(pickle.load(f))
        with open(path, encoding="utf-8") as f:
            sd = json.load(f)
        sd["beatmap_idx"] = {int(k): v for k, v in (sd.get("beatmap_idx") or {}).items()}
        sd["beatmap_mapper"] = {int(k): v for k, v in (sd.get("beatmap_mapper") or {}).items()}
        sd["mapper_idx"] = {int(k): v for k, v in (sd.get("mapper_idx") or {}).items()}
        sd["beatmap_descriptors"] = {int(k): v for k, v in (sd.get("beatmap_descriptors") or {}).items()}
        return cls.from_state_dict(sd)
