"""DiT coordinate refinement on the PyTorch port: a port of the JAX
``infer/diffusion_pipeline.py`` (reference: ``diffusion_pipeline.py:38-470``).

Events -> 20-dim feature sequence (positions, time, distance, 16 one-hot type
classes incl. new-combo and repeat variants) -> chunked DDPM sampling over
the whole song with banded attention, overlap-buffer re-noising at seams,
dual-batch CFG, and in-painting: known positions are kept, and slider end
positions are recomputed from the current anchor samples and SV each step.
An optional refine model then takes ``refine_iters`` steps at t = 0.

The host code is a copy of the JAX module's (``repeat_type``,
``DiffusionSlider``, ``_bucket_len`` and the pipeline's ``get_class_vector``,
``events_to_sequence``, ``events_with_pos``, ``_to_positions`` and
``_slider_recompute_host``; ``tests/test_torch_nojax.py`` holds each to its
source, the context's timestep embedding aside, which runs through the
port's :func:`..models.dit.timestep_embedding` on the CPU).

The device code is a port. Each chunk is padded to a power-of-two bucket, as
in JAX, and the padded keys are masked: the DiT attends through kernel B
with the band ``diffusion.data.seq_len`` and the key mask ``arange(bucket) <
t_len``. The loop runs one eager step at a time. Where the chunk has
sliders, each step's ``denoised_fn`` takes the in-painted prediction to the
host, recomputes the slider ends there (the JAX ``jax.pure_callback``) and
brings it back.

Noise comes from ``noise``: a ``torch.Generator`` (by default one seeded
with ``args.seed`` on the model's device, anew for each ``generate``), or a
keyed callable ``noise(shape, where)``, where ``where`` is ``("init", 0)``
for the ``random_init`` draw and ``("chunk", i, k)`` for the k-th draw of
chunk i (its DDPM steps in loop order, then its refine steps). A keyed
callable can replay the JAX draws, whose keys follow the same tree.

The class vector's vocabulary is ``DiffusionVocab.from_args(args.diffusion)``,
as the JAX training exports each bundle's ``class_size``; the JAX pipeline's
default, an empty ``DiffusionVocab()``, fits no exported bundle (ROADMAP
section 3). A DiT whose ``class_size`` differs from the vocabulary's raises.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..diffusion import create_diffusion
from ..diffusion.gaussian import normal, scoped
from ..diffusion.vocab import DiffusionVocab
from ..models.dit import timestep_embedding
from ..osu.curves import SliderPath
from ..osu.events import Event, EventType
from ..osu.streams import get_groups, update_event_times


def repeat_type(repeat: int) -> int:
    """Slider repeat-count class (reference: data_loading.py:43-49)."""
    if repeat < 4:
        return repeat - 1
    elif repeat % 2 == 0:
        return 3
    else:
        return 4


@dataclasses.dataclass
class DiffusionSlider:
    seq_indices: np.ndarray
    end_index: int
    curve_type: Optional[str]
    length: Optional[float]


PLAYFIELD = np.array([512.0, 384.0])


def _bucket_len(t: int, floor: int = 16) -> int:
    """Smallest power-of-two >= t (min ``floor``)."""
    b = floor
    while b < t:
        b *= 2
    return b


class DiffusionPipeline:
    def __init__(self, args, model, refine_model=None, noise=None):
        """``model`` and ``refine_model``: :class:`..models.dit.DiT` on one
        device, where the pipeline samples."""
        self.model = model
        self.refine = refine_model
        self.vocab = DiffusionVocab.from_args(args.diffusion)
        if self.vocab.num_tokens != model.cfg.class_size:
            raise ValueError(f"the diffusion vocabulary has {self.vocab.num_tokens} classes, the DiT's class_size is "
                             f"{model.cfg.class_size}: compose the diffusion config the model was trained with")
        self.device = next(model.parameters()).device
        self.noise = noise
        self.diffusion_steps = args.diffusion.model.diffusion_steps
        self.noise_schedule = args.diffusion.model.noise_schedule
        self.seq_len = args.diffusion.data.seq_len
        self.max_seq_len = args.max_seq_len
        self.overlap_buffer = args.overlap_buffer
        self.timesteps = args.timesteps
        self.cfg_scale = args.diff_cfg_scale
        self.refine_iters = args.refine_iters
        self.random_init = args.random_init
        self.types_first = args.train.data.types_first
        self.start_time = args.start_time
        self.end_time = args.end_time
        self.has_sv = args.train.data.add_sv
        self.seed = args.seed if args.seed is not None else 0
        # the slider in-paint reads the current chunk's sliders from these
        self._diffusion = None
        self._cb_sliders: list = []
        self._cb_start: int = 0

    def _get_diffusion(self):
        if self._diffusion is None:
            self._diffusion = create_diffusion(
                timestep_respacing=self.timesteps,
                diffusion_steps=self.diffusion_steps,
                noise_schedule=self.noise_schedule,
            )
        return self._diffusion

    def get_class_vector(self, config) -> np.ndarray:
        """One-hot conditioning vector (reference: diffusion_pipeline.py:66-109)."""
        v = self.vocab
        vec = np.zeros(v.num_tokens, np.float32)
        if v.num_classes > 0:
            vec[v.encode_style(config.beatmap_id) if config.beatmap_id is not None else v.style_unk] = 1
        if v.num_diff_classes > 0:
            vec[v.encode_diff(config.difficulty) if config.difficulty is not None else v.diff_unk] = 1
        if v.num_mapper_classes > 0:
            vec[v.encode_mapper(config.mapper_id) if config.mapper_id is not None else v.mapper_unk] = 1
        if v.num_descriptor_classes > 0:
            if config.descriptors:
                found = [d for d in config.descriptors if d in v.descriptor_idx]
                if found:
                    for d in found:
                        vec[v.encode_descriptor_name(d)] = 1
                else:
                    vec[v.descriptor_unk] = 1
            else:
                vec[v.descriptor_unk] = 1
        if v.num_cs_classes > 0:
            vec[v.encode_cs(config.circle_size) if config.circle_size is not None else v.cs_unk] = 1
        return vec

    # -- events <-> sequence --------------------------------------------------------

    EVENT_INDEX = {
        EventType.CIRCLE: 0,
        EventType.SPINNER: 2,
        EventType.SPINNER_END: 3,
        EventType.SLIDER_HEAD: 4,
        EventType.BEZIER_ANCHOR: 6,
        EventType.PERFECT_ANCHOR: 7,
        EventType.CATMULL_ANCHOR: 8,
        EventType.RED_ANCHOR: 9,
        EventType.LAST_ANCHOR: 10,
        EventType.SLIDER_END: 11,
    }

    NC_TYPES = (EventType.CIRCLE, EventType.SLIDER_HEAD)


    def events_to_sequence(self, events, timing, slider_multiplier):
        """Returns (seq_x (T,2) in [-1,1], seq_o (T,), seq_c (T, E), seq_len,
        seq_indices, sliders) — time-major layouts."""
        event_times: list = []
        update_event_times(events, event_times, types_first=self.types_first)

        groups, group_indices = get_groups(events, event_times=event_times, types_first=self.types_first)

        seq_indices: dict[int, int] = {}
        indices: list[int] = []
        rows: list[np.ndarray] = []
        head_time = 0.0
        last_anchor_time = 0.0
        last_pos = (256.0, 192.0)

        for i, group in enumerate(groups):
            indices.extend(group_indices[i])
            if group.event_type not in self.EVENT_INDEX:
                continue

            time = group.time
            index = self.EVENT_INDEX[group.event_type]
            if group.event_type in self.NC_TYPES and group.new_combo:
                index += 1
            if group.event_type == EventType.SLIDER_END:
                span = last_anchor_time - head_time
                total = time - head_time
                repeats = max(int(round(total / span)), 1) if span > 0 else 1
                index += repeat_type(repeats)
            elif group.event_type == EventType.SLIDER_HEAD:
                head_time = time
            elif group.event_type == EventType.LAST_ANCHOR:
                last_anchor_time = time

            if not group.x or not group.y:
                group.x, group.y = 256, 192
            pos = (group.x, group.y)
            if not group.distance:
                group.distance = float(np.hypot(pos[0] - last_pos[0], pos[1] - last_pos[1]))

            row = np.zeros(20, np.float32)
            row[0], row[1], row[2], row[3] = pos[0], pos[1], time, group.distance
            row[index + 4] = 1
            rows.append(row)

            for j in indices:
                seq_indices[j] = len(rows) - 1
            indices = []
            last_pos = pos

        for j in indices:
            seq_indices[j] = len(rows) - 1

        if not rows:
            return np.zeros((0, 2)), np.zeros(0), np.zeros((0, 0)), 0, {}, []

        seq = np.stack(rows, 0)  # (T, 20)
        seq_x = seq[:, :2] / PLAYFIELD * 2 - 1
        seq_o = seq[:, 2]
        seq_d = seq[:, 3]
        seq_c = np.concatenate(
            [
                timestep_embedding(torch.as_tensor(seq_o * 0.1), 128).numpy(),
                timestep_embedding(torch.as_tensor(seq_d), 128).numpy(),
                seq[:, 4:],
            ],
            axis=1,
        )

        sliders: list[DiffusionSlider] = []
        if self.has_sv and timing is not None and len(timing) > 0:
            slider_head = None
            last_anchor = None
            anchor_info: list = []
            for i, group in enumerate(groups):
                hit_type = group.event_type
                if hit_type == EventType.SLIDER_HEAD:
                    anchor_info = [("Bezier", seq_indices[group_indices[i][0]])]
                    slider_head = group
                    last_anchor = None
                elif hit_type == EventType.BEZIER_ANCHOR:
                    anchor_info.append(("Bezier", seq_indices[group_indices[i][0]]))
                elif hit_type == EventType.PERFECT_ANCHOR:
                    anchor_info.append(("PerfectCurve", seq_indices[group_indices[i][0]]))
                elif hit_type == EventType.CATMULL_ANCHOR:
                    anchor_info.append(("Catmull", seq_indices[group_indices[i][0]]))
                elif hit_type == EventType.RED_ANCHOR:
                    anchor_info.append(("Bezier", seq_indices[group_indices[i][0]]))
                    anchor_info.append(("Bezier", seq_indices[group_indices[i][0]]))
                elif hit_type == EventType.LAST_ANCHOR:
                    anchor_info.append(("Bezier", seq_indices[group_indices[i][0]]))
                    last_anchor = group
                elif hit_type == EventType.SLIDER_END and slider_head is not None and last_anchor is not None:
                    curve_type = anchor_info[1][0] if len(anchor_info) > 1 else "Bezier"
                    span = last_anchor.time - slider_head.time
                    tp = self._timing_point_at(int(round(slider_head.time)), timing)
                    redline = tp if tp.parent is None else tp.parent
                    if slider_head.scroll_speed is not None:
                        length = slider_head.scroll_speed * span * 100 / redline.ms_per_beat * slider_multiplier
                        sliders.append(
                            DiffusionSlider(
                                np.array([a[1] for a in anchor_info]),
                                seq_indices[group_indices[i][0]],
                                curve_type,
                                length,
                            )
                        )
                    slider_head = None
                    last_anchor = None
                    anchor_info = []

        return seq_x, seq_o, seq_c, seq.shape[0], seq_indices, sliders

    @staticmethod
    def _timing_point_at(time, timing_points):
        for tp in reversed(timing_points):
            if tp.offset <= time:
                return tp
        return timing_points[0]

    # -- generation ----------------------------------------------------------------

    @torch.no_grad()
    def generate(self, events: list[Event], generation_config, timing, verbose: bool = False) -> list[Event]:
        seq_x, seq_o, seq_c, seq_len, seq_indices, sliders = self.events_to_sequence(
            events, timing, generation_config.slider_multiplier
        )
        if seq_len == 0:
            return events

        diffusion = self._get_diffusion()

        class_vector = self.get_class_vector(generation_config)
        null_cfg = dataclasses.replace(
            generation_config,
            beatmap_id=None,
            mapper_id=None,
            descriptors=generation_config.negative_descriptors,
        )
        unk_class_vector = self.get_class_vector(null_cfg)

        # CFG dual batch: [cond; uncond]
        z = np.stack([seq_x, seq_x], 0)  # (2, T, 2)
        c = np.stack([seq_c, seq_c], 0)
        y = np.stack([class_vector, unk_class_vector], 0)

        noise = self.noise
        if noise is None:
            noise = torch.Generator(device=self.device).manual_seed(self.seed)
        if self.random_init:
            z = normal(scoped(noise, "init"), z.shape, torch.empty(0, device=self.device)).cpu().numpy()

        full = z.copy()
        stride = self.max_seq_len - self.overlap_buffer * 2
        starts = list(range(0, max(seq_len - self.overlap_buffer * 2, 1), max(stride, 1)))
        for chunk, i in enumerate(starts):
            end = min(i + self.max_seq_len, seq_len)
            if i > 0:
                # re-noise the second overlap buffer before regenerating it
                full[:, i + self.overlap_buffer : i + self.overlap_buffer * 2] = z[
                    :, i + self.overlap_buffer : i + self.overlap_buffer * 2
                ]
            samples = self._sample_part(
                diffusion, full, c, y, seq_o, sliders, i, end,
                start_mask_size=self.overlap_buffer if i > 0 else 0,
                source=scoped(noise, "chunk", chunk), verbose=verbose,
            )
            full[:, i:end] = samples

        positions = self._to_positions(full)
        return self.events_with_pos(events, positions[0], seq_indices)

    @staticmethod
    def _to_positions(samples: np.ndarray) -> np.ndarray:
        half = samples[: samples.shape[0] // 2]
        return (half + 1) / 2 * PLAYFIELD

    def _slider_recompute_host(self, x_np: np.ndarray) -> np.ndarray:
        """Per-step slider-end in-paint (irregular host geometry). Reads the
        current chunk's sliders from ``self._cb_sliders``/``_cb_start`` so
        the compiled loop that embeds this callback is reusable across
        chunks and songs."""
        pos = (x_np[: x_np.shape[0] // 2] + 1) / 2 * PLAYFIELD
        coords = pos[0]
        for s in self._cb_sliders:
            path = SliderPath(s.curve_type, coords[s.seq_indices - self._cb_start])
            max_length = path.get_distance()
            if max_length == 0:
                continue
            coords[s.end_index - self._cb_start] = path.position_at(s.length / max_length)
        renorm = coords / PLAYFIELD * 2 - 1
        return np.broadcast_to(renorm[None], x_np.shape).astype(x_np.dtype)

    def _slider_in_paint(self, x: torch.Tensor) -> torch.Tensor:
        """:meth:`_slider_recompute_host` as a round trip from the device."""
        return torch.from_numpy(self._slider_recompute_host(x.cpu().numpy())).to(x.device)

    def _sample_part(self, diffusion, full, c, y, seq_o, sliders, start, end, start_mask_size, source, verbose):
        t_len = end - start
        # pad the chunk to a power-of-two bucket (the JAX shapes, so the
        # draws match); padded keys are masked out of attention, so real rows
        # are unaffected
        bucket = _bucket_len(t_len)
        z_part = np.zeros((full.shape[0], bucket, full.shape[2]), full.dtype)
        z_part[:, :t_len] = full[:, start:end]
        c_part = np.zeros((c.shape[0], bucket, c.shape[2]), c.dtype)
        c_part[:, :t_len] = c[:, start:end]
        o_part = seq_o[start:end]

        # in-paint mask: True = generate (padded tail stays untouched)
        mask = np.zeros(z_part.shape, bool)
        mask[:, start_mask_size:t_len] = True
        if self.start_time is not None:
            start_idx = int(np.searchsorted(o_part, self.start_time, side="left"))
            mask[:, :start_idx] = False
        if self.end_time is not None:
            end_idx = int(np.searchsorted(o_part, self.end_time, side="right"))
            mask[:, end_idx:t_len] = False
        if not mask.any():
            return np.asarray(z_part[:, :t_len])

        part_sliders = [
            s for s in sliders
            if not (np.any((s.seq_indices < start) | (s.seq_indices >= end)) or not (start <= s.end_index < end))
        ]
        self._cb_sliders = part_sliders
        self._cb_start = start

        dev = self.device
        z_t = torch.as_tensor(z_part).to(dev, torch.float32)
        mask_t = torch.as_tensor(mask, device=dev)
        c_t = torch.as_tensor(c_part).to(dev, torch.float32)
        y_t = torch.as_tensor(y).to(dev, torch.float32)
        key_valid = torch.arange(bucket, device=dev) < t_len

        def denoised_fn(x, keep=z_t, mask_j=mask_t):
            x = torch.where(mask_j, x, keep)
            if part_sliders:
                x = self._slider_in_paint(x)
            return x

        def model_fn(x, t):
            return self.model.forward_with_cfg(x, t, c_t, y_t, self.cfg_scale, band=self.seq_len, key_valid=key_valid)

        samples = diffusion.p_sample_loop(
            model_fn, source=source, noise=denoised_fn(z_t), clip_denoised=True, denoised_fn=denoised_fn
        )[:, :t_len]

        if self.refine is not None:
            # the refine steps run on the unbucketed chunk, every key real
            z_real, mask_real, c_real = z_t[:, :t_len], mask_t[:, :t_len], c_t[:, :t_len]

            def refine_fn(x, t):
                return self.refine.forward_with_cfg(x, t, c_real, y_t, self.cfg_scale, band=self.seq_len)

            t = torch.zeros((samples.shape[0],), dtype=torch.int64, device=dev)
            for _ in range(self.refine_iters):
                samples = diffusion.p_sample(
                    refine_fn, samples, t, source, clip_denoised=True,
                    denoised_fn=lambda x: denoised_fn(x, z_real, mask_real),
                )["sample"]

        return samples.cpu().numpy()

    @staticmethod
    def events_with_pos(events: list[Event], sampled_seq: np.ndarray, seq_indices: dict) -> list[Event]:
        new_events = []
        for i, event in enumerate(events):
            if event.type == EventType.DISTANCE:
                index = seq_indices[i]
                new_events.append(Event(EventType.POS_X, int(round(float(sampled_seq[index, 0])))))
                new_events.append(Event(EventType.POS_Y, int(round(float(sampled_seq[index, 1])))))
            elif event.type == EventType.POS_X:
                index = seq_indices[i]
                new_events.append(Event(EventType.POS_X, int(round(float(sampled_seq[index, 0])))))
            elif event.type == EventType.POS_Y:
                index = seq_indices[i]
                new_events.append(Event(EventType.POS_Y, int(round(float(sampled_seq[index, 1])))))
            else:
                new_events.append(event)
        return new_events
