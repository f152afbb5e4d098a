"""osu! domain layer: event language, tokenizer, beatmap parsing/rendering,
slider geometry, and timing-point algebra. Pure host-side Python — zero JAX
dependence — shared by the data, inference, and evaluation layers."""

from .beatmap import Beatmap, Circle, HitObject, HoldNote, Slider, Spinner, TimingPoint  # noqa: F401
from .curves import SliderPath  # noqa: F401
from .events import ContextType, Event, EventRange, EventType  # noqa: F401
from .parsing import BeatmapParser  # noqa: F401
from .timing import TimingPointsChange, sort_timing_points  # noqa: F401
from .vocab import MILLISECONDS_PER_STEP, Vocabulary, build_vocabulary  # noqa: F401
