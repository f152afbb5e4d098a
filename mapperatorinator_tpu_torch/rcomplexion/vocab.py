"""Rhythm-complexion tokenizer: PAD + quantized time-shifts (output range) +
six hit-object marker tokens (input-only range)
(reference: ``rcomplexion/libs/tokenizer/tokenizer.py:6-92``)."""

from __future__ import annotations

from ..osu.events import Event, EventRange, EventType

MARKER_TYPES = (
    EventType.CIRCLE,
    EventType.SPINNER,
    EventType.SPINNER_END,
    EventType.SLIDER_HEAD,
    EventType.LAST_ANCHOR,
    EventType.SLIDER_END,
)


class RTokenizer:
    """Fixed vocabulary: id 0 = PAD, then the time-shift range, then markers."""

    def __init__(self, args):
        self._offset = 1
        max_shift = int((args.data.max_time - args.data.min_time) * args.data.time_resolution)
        self.event_ranges = [EventRange(EventType.TIME_SHIFT, 0, max_shift)]
        self.input_event_ranges = [EventRange(t, 0, 0) for t in MARKER_TYPES]

        self.event_range = {er.type: er for er in self.event_ranges} | {
            er.type: er for er in self.input_event_ranges
        }
        self.event_start: dict[EventType, int] = {}
        self.event_end: dict[EventType, int] = {}
        offset = self._offset
        for er in list(self.event_ranges) + list(self.input_event_ranges):
            self.event_start[er.type] = offset
            offset += er.max_value - er.min_value + 1
            self.event_end[er.type] = offset

        self.vocab_size_out = self._offset + sum(
            er.max_value - er.min_value + 1 for er in self.event_ranges
        )
        self.vocab_size_in = self.vocab_size_out + sum(
            er.max_value - er.min_value + 1 for er in self.input_event_ranges
        )

    @property
    def pad_id(self) -> int:
        return 0

    def encode(self, event: Event) -> int:
        er = self.event_range[event.type]
        if not er.min_value <= event.value <= er.max_value:
            raise ValueError(f"event value {event.value} outside range [{er.min_value}, {er.max_value}]")
        return self.event_start[event.type] + event.value - er.min_value

    def decode(self, token_id: int) -> Event:
        for er in list(self.event_ranges) + list(self.input_event_ranges):
            start = self.event_start[er.type]
            if start <= token_id < self.event_end[er.type]:
                return Event(er.type, er.min_value + token_id - start)
        raise ValueError(f"token id {token_id} outside vocabulary")
