"""Event-stream utilities: time assignment/interpolation, merging, grouping,
and beatmap statistics (reference: ``osuT5/osuT5/dataset/data_utils.py:22-79,
724-1082``)."""

from __future__ import annotations

import dataclasses
from typing import Optional

from .beatmap import Beatmap, HoldNote, TimingPoint
from .events import Event, EventType

MILLISECONDS_PER_SECOND = 1000
STEPS_PER_MILLISECOND = 0.1
LABEL_IGNORE_ID = -100

BEAT_TYPES = [EventType.BEAT, EventType.MEASURE, EventType.TIMING_POINT]
TIMING_TYPES = BEAT_TYPES + [EventType.TIME_SHIFT]

TYPE_EVENTS = [
    EventType.CIRCLE,
    EventType.SPINNER,
    EventType.SPINNER_END,
    EventType.SLIDER_HEAD,
    EventType.BEZIER_ANCHOR,
    EventType.PERFECT_ANCHOR,
    EventType.CATMULL_ANCHOR,
    EventType.RED_ANCHOR,
    EventType.LAST_ANCHOR,
    EventType.SLIDER_END,
    EventType.BEAT,
    EventType.MEASURE,
    EventType.TIMING_POINT,
    EventType.KIAI,
    EventType.HOLD_NOTE,
    EventType.HOLD_NOTE_END,
    EventType.DRUMROLL,
    EventType.DRUMROLL_END,
    EventType.DENDEN,
    EventType.DENDEN_END,
    EventType.SCROLL_SPEED_CHANGE,
]

NON_TIMED_EVENTS = [
    EventType.BEZIER_ANCHOR,
    EventType.PERFECT_ANCHOR,
    EventType.CATMULL_ANCHOR,
    EventType.RED_ANCHOR,
]

TIMED_EVENTS = [
    EventType.CIRCLE,
    EventType.SPINNER,
    EventType.SPINNER_END,
    EventType.SLIDER_HEAD,
    EventType.LAST_ANCHOR,
    EventType.SLIDER_END,
    EventType.BEAT,
    EventType.MEASURE,
    EventType.TIMING_POINT,
    EventType.KIAI,
    EventType.HOLD_NOTE,
    EventType.HOLD_NOTE_END,
    EventType.DRUMROLL,
    EventType.DRUMROLL_END,
    EventType.DENDEN,
    EventType.DENDEN_END,
    EventType.SCROLL_SPEED_CHANGE,
]


def update_event_times(
    events: list[Event],
    event_times: list[int],
    end_time: Optional[float] = None,
    types_first: bool = False,
) -> None:
    """Extend ``event_times`` to cover newly appended events, assigning each
    the running TIME_SHIFT value, then interpolate times for slider anchors
    (reference: data_utils.py:724-804)."""
    start_index = len(event_times)
    end_index = len(events)
    if start_index == end_index:
        return

    current_time = 0 if len(event_times) == 0 else event_times[-1]
    for i in range(start_index, end_index):
        if types_first:
            if i + 1 < end_index and events[i + 1].type == EventType.TIME_SHIFT:
                current_time = events[i + 1].value
        elif events[i].type == EventType.TIME_SHIFT:
            current_time = events[i].value
        event_times.append(current_time)

    # Interpolate anchor times between the surrounding timed events.
    interpolate = False
    if types_first:
        index = range(start_index, end_index)
        current_time = 0 if len(event_times) == 0 else event_times[start_index]
    else:
        index = range(end_index - 1, start_index - 1, -1)
        current_time = end_time if end_time is not None else event_times[-1]

    for i in index:
        event = events[i]
        if event.type in TIMED_EVENTS:
            interpolate = False
        if event.type in NON_TIMED_EVENTS:
            interpolate = True
        if not interpolate:
            current_time = event_times[i]
            continue
        if event.type not in NON_TIMED_EVENTS:
            event_times[i] = current_time
            continue

        # distance (in events) to the nearest TIME_SHIFT, counting anchors
        j = i
        step = 1 if types_first else -1
        count = 0
        other_time = current_time
        while 0 <= j < len(events):
            event2 = events[j]
            if event2.type == EventType.TIME_SHIFT:
                other_time = event_times[j]
                break
            if event2.type in NON_TIMED_EVENTS:
                count += 1
            j += step
        if j < 0:
            other_time = 0
        if j >= len(events):
            other_time = end_time if end_time is not None else event_times[-1]

        current_time = int((current_time - other_time) / (count + 1) * count + other_time)
        event_times[i] = current_time


def merge_events(
    a: tuple[list[Event], list[int]], b: tuple[list[Event], list[int]]
) -> tuple[list[Event], list[int]]:
    """Stable time-ordered merge of two sorted event streams; ties favor a."""
    events, times = [], []
    i = j = 0
    ae, at = a
    be, bt = b
    while i < len(ae) and j < len(be):
        if at[i] <= bt[j]:
            events.append(ae[i])
            times.append(at[i])
            i += 1
        else:
            events.append(be[j])
            times.append(bt[j])
            j += 1
    events.extend(ae[i:])
    events.extend(be[j:])
    times.extend(at[i:])
    times.extend(bt[j:])
    return events, times


def remove_events_of_type(
    events: list[Event], event_times: list[int], event_types: list[EventType]
) -> tuple[list[Event], list[int]]:
    kept = [(e, t) for e, t in zip(events, event_times) if e.type not in event_types]
    return [e for e, _ in kept], [t for _, t in kept]


def events_of_type(
    events: list[Event], event_times: list[int], event_types: list[EventType]
) -> tuple[list[Event], list[int]]:
    kept = [(e, t) for e, t in zip(events, event_times) if e.type in event_types]
    return [e for e, _ in kept], [t for _, t in kept]


def speed_events(
    events: tuple[list[Event], list[int]], speed: float
) -> tuple[list[Event], list[int]]:
    """Scale times by 1/speed. Mutates TIME_SHIFT values in place (the
    reference does too — callers rely on it)."""
    out_events = []
    for event in events[0]:
        if event.type == EventType.TIME_SHIFT:
            event.value = int(event.value / speed)
        out_events.append(event)
    return out_events, [int(t / speed) for t in events[1]]


@dataclasses.dataclass
class Group:
    """One hit-object-level unit reassembled from the flat token stream."""

    event_type: Optional[EventType] = None
    value: Optional[int] = None
    time: int = 0
    distance: Optional[int] = None
    x: Optional[float] = None
    y: Optional[float] = None
    new_combo: bool = False
    hitsounds: list = dataclasses.field(default_factory=list)
    samplesets: list = dataclasses.field(default_factory=list)
    additions: list = dataclasses.field(default_factory=list)
    volumes: list = dataclasses.field(default_factory=list)
    scroll_speed: Optional[float] = None


def get_groups(
    events: list[Event],
    *,
    event_times: Optional[list[int]] = None,
    types_first: bool = False,
) -> tuple[list[Group], list[list[int]]]:
    """Group a flat event stream into per-hit-object Groups, supporting both
    token orderings (reference: data_utils.py:922-979)."""
    groups: list[Group] = []
    group = Group()
    group_indices: list[list[int]] = []
    indices: list[int] = []
    for i, event in enumerate(events):
        indices.append(i)
        if event.type == EventType.TIME_SHIFT:
            group.time = event.value
        elif event.type == EventType.DISTANCE:
            group.distance = event.value
        elif event.type == EventType.POS_X:
            group.x = event.value
        elif event.type == EventType.POS_Y:
            group.y = event.value
        elif event.type == EventType.NEW_COMBO:
            group.new_combo = True
        elif event.type == EventType.HITSOUND:
            group.hitsounds.append((event.value % 8) * 2)
            group.samplesets.append(((event.value // 8) % 3) + 1)
            group.additions.append(((event.value // 24) % 3) + 1)
        elif event.type == EventType.VOLUME:
            group.volumes.append(event.value)
        elif event.type == EventType.SCROLL_SPEED:
            group.scroll_speed = event.value / 100
        elif event.type in TYPE_EVENTS:
            if types_first:
                if group.event_type is not None:
                    groups.append(group)
                    group = Group()
                    group_indices.append(indices[:-1])
                    indices = [indices[-1]]
                group.event_type = event.type
                group.value = event.value
                if event_times is not None:
                    group.time = event_times[i]
            else:
                group.event_type = event.type
                group.value = event.value
                if event_times is not None:
                    group.time = event_times[i]
                groups.append(group)
                group = Group()
                group_indices.append(indices)
                indices = []

    if group.event_type is not None:
        groups.append(group)
        group_indices.append(indices)
    elif len(indices) > 0 and group_indices:
        # trailing events without a type attach to the last group; a stream
        # with no groups at all (degenerate model output) yields none
        group_indices[-1].extend(indices)

    return groups, group_indices


# ---------------------------------------------------------------------------
# beatmap statistics
# ---------------------------------------------------------------------------


def get_hold_note_ratio(beatmap: Beatmap) -> Optional[float]:
    notes = beatmap.hit_objects(stacking=False)
    if len(notes) == 0:
        return None
    return sum(1 for n in notes if isinstance(n, HoldNote)) / len(notes)


def get_scroll_speed_ratio(beatmap: Beatmap, mania_normalized: bool = True) -> Optional[float]:
    """Scroll-speed changes per distinct hit-object time
    (reference: data_utils.py:995-1028)."""
    notes = beatmap.hit_objects(stacking=False)
    if len(notes) == 0:
        return None

    last_time = -1.0
    num_note_times = 0
    for note in notes:
        if note.time != last_time:
            num_note_times += 1
            last_time = note.time

    normalized = mania_normalized and beatmap.mode == 3
    median_mpb = get_median_mpb_beatmap(beatmap)
    mpb = median_mpb
    last_scroll = 1.0
    num_changes = 0
    tps = beatmap.timing_points
    for i, tp in enumerate(tps):
        if tp.parent is None:
            mpb = tp.ms_per_beat
            scroll_speed = 1.0
        else:
            scroll_speed = -100 / tp.ms_per_beat
        if i == len(tps) - 1 or tps[i + 1].offset > tp.offset:
            norm_scroll = scroll_speed * median_mpb / mpb if normalized else scroll_speed
            if abs(norm_scroll - last_scroll) > 1e-3:
                num_changes += 1
            last_scroll = norm_scroll

    return num_changes / num_note_times


def get_hitsounded_status(beatmap: Beatmap) -> bool:
    return any(n.hitsound != 0 for n in beatmap.hit_objects(stacking=False))


def get_song_length(samples, sample_rate: int) -> float:
    return len(samples) / sample_rate * MILLISECONDS_PER_SECOND


def _td_seconds(ms: float) -> int:
    """datetime.timedelta(milliseconds=ms).seconds — the reference feeds
    ``offset.seconds`` (whole-seconds component, day-wrapped for negatives)
    into the median-BPM calc (data_utils.py:1046-1059); replicated for
    identical conditioning tokens."""
    day_ms = 86400000
    days = ms // day_ms if ms >= 0 else -((-ms + day_ms - 1) // day_ms)
    rem = ms - days * day_ms
    return int(rem // 1000)


def get_median_mpb_beatmap(beatmap: Beatmap) -> float:
    last_time = max(
        (ho.end_time if isinstance(ho, HoldNote) else ho.time)
        for ho in beatmap.hit_objects(stacking=False)
    )
    last_time = int(_td_seconds(last_time) * MILLISECONDS_PER_SECOND)
    return get_median_mpb(beatmap.timing_points, last_time)


def get_median_mpb(timing_points: list[TimingPoint], last_time: float) -> float:
    """osu!stable-identical duration-weighted modal beat length
    (reference: data_utils.py:1051-1082)."""
    this_beat_length = 0.0
    bpm_durations: dict[float, int] = {}

    for i in range(len(timing_points) - 1, -1, -1):
        tp = timing_points[i]
        offset = int(_td_seconds(tp.offset) * 1000)
        if tp.parent is None:
            this_beat_length = tp.ms_per_beat
        if this_beat_length == 0 or offset > last_time or (tp.parent is not None and i > 0):
            continue
        duration = int(last_time - (0 if i == 0 else offset))
        bpm_durations[this_beat_length] = bpm_durations.get(this_beat_length, 0) + duration
        last_time = offset

    longest_time = 0
    median = 0.0
    for bpm, duration in bpm_durations.items():
        if duration > longest_time:
            longest_time = duration
            median = bpm
    return median
