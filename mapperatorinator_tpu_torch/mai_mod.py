"""MaiMod, the AI modding assistant, on the PyTorch port: the repo's
``mai_mod.py`` with its imports pointing at the port.

Runs the teacher-forced surprisal analysis (``Processor.ai_mod``, the
engine's ``forward_stats`` on the card) over a finished beatmap and renders
human-readable, categorized suggestions with osu://edit timestamps. From the
command line, on the card unless ``inference.device=cpu`` is given:

    python -m mapperatorinator_tpu_torch.mai_mod beatmap_path=map.osu audio_path=song.wav \
        inference.model_path=ckpt/ [raw_output=true]

The configuration is ``configs/mai_mod.yaml`` (v32 under ``inference``),
composed as the JAX script composes it. Where the beatmap's gamemode is not
one the config was trained on, :func:`select_config_for_gamemode` falls back
to the v31 preset (``configs/inference/v31.yaml``, re-composed with the
``inference.*`` overrides), which covers all four modes. The host code is
the JAX file's (``tests/test_torch_nojax.py`` holds it to its source), each
package composing with its own loader.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from pathlib import Path
from string import Template
from typing import Optional

from .config import load_config, load_mai_mod_config
from .osu import Beatmap, ContextType, Event, EventType
from .osu.beatmap import Spinner
from .osu.streams import Group, get_groups

# (real, expected) event-type pairs -> (category, explanation template)
# Designed for V30-style tokenization (reference: mai_mod.py:24-51).
MOD_EXPLANATIONS = {
    (EventType.DISTANCE, EventType.DISTANCE): ("Compose", "Expected distance $expected_value to the previous $previous_group instead of $real_value."),
    (EventType.POS_X, EventType.POS_X): ("Compose", "Expected position $expected_value instead of $real_value."),
    (EventType.POS_Y, EventType.POS_Y): ("Compose", "Expected position $expected_value instead of $real_value."),
    (EventType.POS, EventType.POS): ("Compose", "Expected position $expected_value instead of $real_value."),
    (EventType.MANIA_COLUMN, EventType.MANIA_COLUMN): ("Compose", "Expected column $expected_value instead of $real_value."),
    (EventType.HITSOUND, EventType.HITSOUND): ("Hit Sounds", "Expected hitsound $expected_value instead of $real_value."),
    (EventType.VOLUME, EventType.VOLUME): ("Hit Sounds", "Expected volume $expected_value instead of $real_value."),
    (EventType.HITSOUND, EventType.NEW_COMBO): ("New Combos", "Expected new combo."),
    (EventType.NEW_COMBO, EventType.HITSOUND): ("New Combos", "Unexpected new combo."),
    (EventType.HITSOUND, EventType.LAST_ANCHOR): ("Rhythm", "Expected end of slider repeats."),
    (EventType.HITSOUND, EventType.SLIDER_END): ("Rhythm", "Expected end of slider repeats."),
    (EventType.SNAPPING, EventType.BEAT): ("Timing", "Hit object likely not snapped to a beat."),
    (EventType.SNAPPING, EventType.MEASURE): ("Timing", "Hit object likely not snapped to a beat."),
    (EventType.SNAPPING, EventType.TIMING_POINT): ("Timing", "Hit object likely not snapped to a beat."),
    (EventType.TIME_SHIFT, EventType.DISTANCE): ("Sliders", "Expected additional anchors."),
    (EventType.DISTANCE, EventType.TIME_SHIFT): ("Sliders", "Expected last anchor."),
    (EventType.BEAT, EventType.SNAPPING): ("Timing", "Unexpected beat."),
    (EventType.BEAT, EventType.MEASURE): ("Timing", "Expected new measure."),
    (EventType.BEAT, EventType.TIMING_POINT): ("Timing", "Expected new timing point."),
    (EventType.MEASURE, EventType.SNAPPING): ("Timing", "Unexpected new measure."),
    (EventType.MEASURE, EventType.BEAT): ("Timing", "Unexpected new measure."),
    (EventType.MEASURE, EventType.TIMING_POINT): ("Timing", "Expected new timing point."),
    (EventType.TIMING_POINT, EventType.SNAPPING): ("Timing", "Unexpected new timing point."),
    (EventType.TIMING_POINT, EventType.BEAT): ("Timing", "Unexpected new timing point."),
    (EventType.TIMING_POINT, EventType.MEASURE): ("Timing", "Unexpected new timing point."),
}

POSITION_TYPES = [EventType.DISTANCE, EventType.POS_X, EventType.POS_Y, EventType.POS]
ANCHOR_TYPES = [EventType.RED_ANCHOR, EventType.BEZIER_ANCHOR, EventType.CATMULL_ANCHOR, EventType.PERFECT_ANCHOR]
HS_TYPES = [EventType.HITSOUND, EventType.VOLUME]
TIMING_TYPES_ = [EventType.BEAT, EventType.MEASURE, EventType.TIMING_POINT]
HITOBJECT_TYPES = [
    EventType.CIRCLE, EventType.SPINNER, EventType.SPINNER_END, EventType.SLIDER_HEAD,
    EventType.BEZIER_ANCHOR, EventType.PERFECT_ANCHOR, EventType.CATMULL_ANCHOR, EventType.RED_ANCHOR,
    EventType.LAST_ANCHOR, EventType.SLIDER_END, EventType.HOLD_NOTE, EventType.HOLD_NOTE_END,
    EventType.DRUMROLL, EventType.DRUMROLL_END, EventType.DENDEN, EventType.DENDEN_END,
]


@dataclass
class Suggestion:
    """One high-surprisal token with everything needed to explain it."""

    context_type: ContextType
    index: int
    time: float
    group: Group
    event: Event
    event_str: str
    expected_event: Event
    expected_event_str: str
    surprisal: float
    group_str: str = "None"
    previous_group_str: str = "None"
    next_group: Optional[Group] = None
    next_beat_group: Optional[Group] = None
    combo_index: Optional[int] = None
    timestamp_time: Optional[float] = None


def type_to_str(event_type: EventType) -> str:
    return event_type.value.replace("_", " ").title()


class _GroupIndex:
    """Event-group bookkeeping for one analyzed context: the group list, the
    event→group mapping, and the human-readable labels derived from them."""

    def __init__(self, events, event_times, types_first: bool):
        self.events = events
        self.groups, indices_per_group = get_groups(
            events, event_times=event_times, types_first=types_first
        )
        self.group_of = [0] * len(events)
        for gi, event_indices in enumerate(indices_per_group):
            for ei in event_indices:
                self.group_of[ei] = gi

    def label(self, gi: int, event_index: Optional[int] = None) -> str:
        """Human label for group ``gi``. When ``event_index`` names a
        hitsound/volume event inside its own slider-end group, the label
        resolves to the specific repeat ("Slider Body" / "Slider Repeat #n");
        anchors are numbered within their slider."""
        if not (0 <= gi < len(self.groups)):
            return "None"
        group = self.groups[gi]
        if (
            group.event_type == EventType.LAST_ANCHOR
            and event_index is not None
            and gi == self.group_of[event_index]
            and self.events[event_index].type in HS_TYPES
        ):
            return self._repeat_label(event_index)
        if group.event_type in ANCHOR_TYPES:
            return f"{type_to_str(group.event_type)} #{self._anchor_number(gi)}"
        return type_to_str(group.event_type)

    def _repeat_label(self, event_index: int) -> str:
        # a slider-end group holds one hitsound/volume event per repeat; the
        # event's position among its same-typed predecessors (back to the
        # slider's TIME_SHIFT) says which repeat it belongs to
        wanted = self.events[event_index].type
        repeat = 0
        for prior in reversed(self.events[:event_index]):
            if prior.type == EventType.TIME_SHIFT:
                break
            if prior.type == wanted:
                repeat += 1
        return f"Slider Repeat #{repeat}" if repeat else "Slider Body"

    def _anchor_number(self, gi: int) -> int:
        # anchors display 1-based counting the slider head as #1
        number = 2
        for prior in reversed(self.groups[:gi]):
            if prior.event_type == EventType.SLIDER_HEAD:
                break
            if prior.event_type in ANCHOR_TYPES:
                number += 1
        return number

    def next_timing_group(self, gi: int) -> Optional[Group]:
        return next(
            (g for g in self.groups[gi + 1:] if g.event_type in TIMING_TYPES_), None
        )

    def previous_positioned_label(self, gi: int) -> str:
        for prior_gi in range(gi - 1, -1, -1):
            if self.groups[prior_gi].x is not None:
                return self.label(prior_gi)
        return "None"


def _worth_reporting(s: Suggestion, threshold: float) -> bool:
    """Noise gate over raw surprisals (reference: mai_mod.py:206-215)."""
    if s.surprisal < threshold:
        return False
    # position tokens on slider ends are determined by the curve, not the
    # mapper — the model's disagreement there is not actionable
    if s.group.event_type == EventType.SLIDER_END and s.event.type in POSITION_TYPES:
        return False
    # sub-10ms timing disagreements are quantization noise
    if (
        s.event.type == EventType.TIME_SHIFT
        and s.expected_event.type == EventType.TIME_SHIFT
        and abs(s.expected_event.value - s.event.value) <= 10
    ):
        return False
    # snapping-vs-beat confusions within 2ms of the next group are the same
    # moment tokenized two ways
    timing_confusion = (
        s.event.type == EventType.SNAPPING and s.expected_event.type in TIMING_TYPES_
    ) or (
        s.event.type in TIMING_TYPES_ and s.expected_event.type == EventType.SNAPPING
    )
    if timing_confusion and s.next_group and abs(s.time - s.next_group.time) < 2:
        return False
    return True


def _combo_positions(hitobjects) -> list[int]:
    """1-based combo position of every hit object, resetting on new combos,
    spinners (either side), and >10s gaps (reference: mai_mod.py:222-231)."""
    positions = []
    for i, ho in enumerate(hitobjects):
        resets = (
            i == 0
            or ho.new_combo
            or isinstance(ho, Spinner)
            or isinstance(hitobjects[i - 1], Spinner)
            or ho.time - hitobjects[i - 1].time > 10000
        )
        positions.append(1 if resets else positions[-1] + 1)
    return positions


def _attach_editor_locations(suggestions, hitobjects) -> None:
    """Give each hit-object-related suggestion the editor address of the
    object it points at: the last hit object starting at or before the
    suggestion time (±1ms), as (combo position, object time). The osu! editor
    resolves ``osu://edit/<time> (<combo>)`` links through exactly that pair."""
    if not hitobjects:
        return
    times = [ho.time for ho in hitobjects]
    combos = _combo_positions(hitobjects)
    from bisect import bisect_right

    for s in suggestions:
        if s.group.event_type not in HITOBJECT_TYPES:
            continue
        # the last object with time - 1 <= s.time (clamped to the first)
        at = max(0, bisect_right(times, s.time + 1) - 1)
        s.combo_index = combos[at]
        s.timestamp_time = int(times[at] + 1e-5)


def _mmssms(t: int) -> str:
    """osu! editor timestamp: minutes:seconds:milliseconds."""
    return f"{t // 60000:02}:{t // 1000 % 60:02}:{t % 1000:03}"


def _edit_address(s: Suggestion) -> str:
    """Address part of an ``osu://edit`` link: the object time, plus the
    combo position in URL-encoded parentheses when one is known."""
    t = int(s.time if s.timestamp_time is None else s.timestamp_time)
    address = _mmssms(t)
    if s.combo_index is not None:
        address += f"%20({s.combo_index})"
    return address


# (threshold on surprisal/10, left padding, rich markup), most severe first
_SURPRISAL_TIERS = [
    (10000, 0, "bold red"),
    (1000, 1, "bold red"),
    (100, 2, "bold red"),
    (10, 3, "bold yellow"),
    (1, 4, "bold"),
]


def _surprisal_text(surprisal: float) -> str:
    """Right-aligned importance figure, color-coded by magnitude."""
    value = surprisal / 10.0
    for threshold, pad, markup in _SURPRISAL_TIERS:
        if value >= threshold:
            return " " * pad + f"[{markup}]({value:.0f})[/{markup}]"
    return f"    ({value:.0f})"


def _categorize(s: Suggestion, *, timing_conditioned: bool,
                beatmap_mode: int) -> tuple:
    """(category, explanation template) for one suggestion. Special cases go
    most-specific-first; anything unmatched falls through to the
    (real, expected) pair table, then to Misc (reference: mai_mod.py:264-308)."""
    real, expected = s.event.type, s.expected_event.type

    # the model predicted the time of the next beat where the map has an
    # object: it expects no hit object here at all
    if (
        timing_conditioned
        and real == EventType.TIME_SHIFT and expected == EventType.TIME_SHIFT
        and s.group.event_type not in TIMING_TYPES_
        and s.next_beat_group is not None
        and abs(s.expected_event.value - s.next_beat_group.time) <= 10
    ):
        return "Rhythm", "Unexpected hit object."

    if real == EventType.LAST_ANCHOR and expected in ANCHOR_TYPES:
        return "Sliders", "Expected additional anchors."
    if real in ANCHOR_TYPES and expected == EventType.LAST_ANCHOR:
        return "Sliders", "Expected last anchor."
    if real in ANCHOR_TYPES and expected in ANCHOR_TYPES:
        return "Sliders", "Expected a $expected_type instead of a $real_type."
    if real in HITOBJECT_TYPES and expected in HITOBJECT_TYPES:
        return "Rhythm", "Expected a $expected_type instead of a $real_type."

    if real == expected and real in (EventType.TIME_SHIFT, EventType.SNAPPING):
        # what the mistimed token belongs to decides the category
        if s.group.event_type in HITOBJECT_TYPES:
            category = "Rhythm"
        elif s.group.event_type == EventType.SCROLL_SPEED_CHANGE:
            category = "Scroll Speeds"
        elif s.group.event_type == EventType.KIAI:
            category = "Kiai"
        else:
            category = "Timing"
        if real == EventType.TIME_SHIFT:
            return category, "Expected object at $expected_value instead of $real_value."
        return category, "Expected snapping $expected_value instead of $real_value."

    if real == EventType.SCROLL_SPEED and expected == EventType.SCROLL_SPEED:
        # osu!standard calls this dimension slider velocity
        if beatmap_mode == 0:
            return "Sliders", "Expected slider velocity $expected_value instead of $real_value."
        return "Scroll Speeds", "Expected scroll speed $expected_value instead of $real_value."

    if expected == EventType.CONTROL:
        if real == EventType.KIAI:
            which = "start" if s.event.value == 1 else "end"
            return "Kiai", f"Unexpected kiai section {which}."
        return "Timing", "Expected end of beatmap."

    return MOD_EXPLANATIONS.get(
        (real, expected),
        ("Misc", "Expected $expected_type $expected_value instead of $real_type $real_value."),
    )


def ai_mod(
    args,
    *,
    generation_config,
    engine,
    vocab,
    audio_path: Optional[str] = None,
    beatmap_path: Optional[str] = None,
    verbose: bool = True,
    raw_output: bool = False,
    surprisal_threshold: float = 20.0,
    structured: bool = False,
):
    from .infer import Preprocessor, Processor

    i_args = args.inference if hasattr(args, "inference") else args
    audio_path = i_args.audio_path if audio_path is None else audio_path
    beatmap_path = i_args.beatmap_path if beatmap_path is None else beatmap_path

    if not Path(audio_path).is_file():
        raise FileNotFoundError(f"Provided audio file path does not exist: {audio_path}")
    if beatmap_path and not Path(beatmap_path).is_file():
        raise FileNotFoundError(f"Provided beatmap file path does not exist: {beatmap_path}")

    preprocessor = Preprocessor(i_args, parallel=False)
    processor = Processor(i_args, engine, vocab)

    audio = preprocessor.load(audio_path)
    sequences = preprocessor.segment(audio)

    result = processor.ai_mod(
        sequences=sequences,
        generation_config=generation_config,
        beatmap_path=beatmap_path,
        verbose=verbose,
    )

    suggestions: list[Suggestion] = []
    types_first = i_args.train.data.types_first
    for context in result:
        index = _GroupIndex(context["events"], context["event_times"], types_first)
        rows = zip(
            context["events"], context["events_str"],
            context["expected_events"], context["expected_events_str"],
            context["surprisals"], context["event_times"],
        )
        for ei, (event, event_str, expected, expected_str, surprisal, time) in enumerate(rows):
            gi = index.group_of[ei]
            suggestions.append(Suggestion(
                context_type=context["context_type"],
                index=ei,
                time=time,
                group=index.groups[gi],
                event=event,
                event_str=event_str,
                expected_event=expected,
                expected_event_str=expected_str,
                surprisal=surprisal,
                group_str=index.label(gi, event_index=ei),
                previous_group_str=index.previous_positioned_label(gi),
                next_group=index.groups[gi + 1] if gi + 1 < len(index.groups) else None,
                next_beat_group=index.next_timing_group(gi),
            ))

    suggestions.sort(key=lambda s: s.time)
    suggestions = [s for s in suggestions if _worth_reporting(s, surprisal_threshold)]

    beatmap = Beatmap.from_path(beatmap_path)
    _attach_editor_locations(suggestions, beatmap.hit_objects(stacking=False))

    def timestamp_text(s: Suggestion) -> str:
        timestamp = _mmssms(int(s.time))
        url = f"osu://edit/{_edit_address(s)}"
        return f"[link={url}][green]{timestamp}[/green][/link]"

    suggestions_by_category: dict[str, list[str]] = {}
    records: list[dict] = []
    timing_conditioned = i_args.train.data.add_timing
    for s in suggestions:
        category, template = _categorize(
            s, timing_conditioned=timing_conditioned, beatmap_mode=beatmap.mode
        )
        explanation = Template(template).safe_substitute(
            {
                "expected_value": s.expected_event_str,
                "real_value": s.event_str,
                "expected_type": type_to_str(s.expected_event.type),
                "real_type": type_to_str(s.event.type),
                "group": s.group_str,
                "previous_group": s.previous_group_str,
            }
        )
        suggestions_by_category.setdefault(category, []).append(
            f"{_surprisal_text(s.surprisal)} {timestamp_text(s)} ({s.group_str}) - {explanation}"
        )
        records.append({
            "category": category,
            "message": explanation,
            "surprisal": float(s.surprisal) / 10.0,
            "timestamp": _mmssms(int(s.time)),
            "edit_link": f"osu://edit/{_edit_address(s)}",
            "group": s.group_str,
        })

    p = print
    if not raw_output:
        try:
            from rich.console import Console

            p = Console(width=900).print
        except ImportError:
            pass

    p(
        "The first value between parentheses represents the importance of the suggestion. "
        "Values above [red]100[/red] are likely issues, whereas values below 10 are likely subjective"
    )
    p(f"Found {len(suggestions)} suggestions:")
    for category in sorted(suggestions_by_category):
        print(f"\n{category}:")
        for item in suggestions_by_category[category][:10]:
            p(f" {item}")

    if structured:
        return records
    return suggestions_by_category


def select_config_for_gamemode(i_args, fallback: str = "v31", verbose: bool = True,
                               overrides: Optional[list] = None):
    """When the beatmap's gamemode is not among the config's trained
    gamemodes, fall back to the v31 inference preset, which covers all four
    modes (reference: mai_mod.py:337-360). User-facing paths and the seed
    carry over, and any explicit ``inference.*`` CLI ``overrides`` are
    re-applied on the fallback compose; everything else takes the fallback
    preset's defaults."""
    beatmap_path = i_args.beatmap_path
    if not beatmap_path:
        return i_args
    beatmap_path = Path(beatmap_path)
    if not beatmap_path.is_file():
        raise FileNotFoundError(f"Provided beatmap file path does not exist: {beatmap_path}")
    if beatmap_path.suffix.lower() != ".osu":
        raise ValueError(f"Beatmap file must have .osu extension: {beatmap_path}")
    mode = Beatmap.from_path(beatmap_path).mode
    if mode in i_args.train.data.gamemodes:
        return i_args
    if verbose:
        print(f"Gamemode {mode} is not supported by the selected config; falling back to {fallback}")
    inference_overrides = [
        o.split("inference.", 1)[1] for o in (overrides or []) if o.startswith("inference.")
    ]
    new_args = load_config(fallback, inference_overrides)
    for key in ("beatmap_path", "audio_path", "output_path", "precision", "seed"):
        setattr(new_args, key, getattr(i_args, key))
    new_args.gamemode = mode
    return new_args


def run_analysis(i_args, surprisal_threshold: float = 20.0) -> list[dict]:
    """Programmatic MaiMod entry for the web UIs: load the model, analyze
    ``i_args.beatmap_path``, and return structured suggestion records
    (category / message / surprisal / timestamp / osu://edit link)."""
    from .inference import compile_args, get_config, load_model

    i_args = select_config_for_gamemode(i_args)
    engine, vocab = load_model(i_args)
    compile_args(i_args, vocab)
    generation_config, _ = get_config(i_args)
    return ai_mod(
        i_args,
        generation_config=generation_config,
        engine=engine,
        vocab=vocab,
        beatmap_path=i_args.beatmap_path,
        raw_output=True,
        surprisal_threshold=surprisal_threshold,
        structured=True,
    )


def main(argv=None) -> None:
    from .inference import compile_args, get_config, load_model

    argv = sys.argv[1:] if argv is None else argv
    config_name = "mai_mod"
    overrides = []
    i = 0
    while i < len(argv):
        if argv[i] in ("-cn", "--config-name"):
            config_name = argv[i + 1]
            i += 2
        else:
            overrides.append(argv[i])
            i += 1

    args = load_mai_mod_config(config_name, overrides)
    i_args = args.inference
    i_args.beatmap_path = args.beatmap_path
    i_args.audio_path = args.audio_path
    i_args.precision = args.precision

    # gamemode-unsupported configs fall back to v31 with the user's explicit
    # inference overrides re-applied (reference: mai_mod.py:337-360)
    fallback_args = select_config_for_gamemode(i_args, overrides=overrides)
    if fallback_args is not i_args:
        i_args = args.inference = fallback_args

    engine, vocab = load_model(i_args)
    compile_args(i_args, vocab)
    generation_config, _ = get_config(i_args)

    return ai_mod(
        args,
        generation_config=generation_config,
        engine=engine,
        vocab=vocab,
        beatmap_path=args.beatmap_path,
        raw_output=args.raw_output,
    )


if __name__ == "__main__":
    main()
