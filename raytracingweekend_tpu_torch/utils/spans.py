"""Host spans of the render path, on the profiler's clock.

A span is one step of the host's work on an image: its name, its start
and end on `time.time_ns()`, the span open around it, and the image and
launch it belongs to. `time.time_ns()` is the clock of torch.profiler's
host events (Unix-epoch nanoseconds), so spans lie on its timeline with
no calibration. (Its device events are on the card's clock as the
profiler maps it to the host's, which can drift by a millisecond within
a long session: set them against spans by a read both clocks see.)

Spans record exactly while a torch.profiler session records in the
process: a benchmark's traced run and `render --profile` get them with no
option of their own. Otherwise a span site reads one flag, and reads no
clock, allocates nothing and touches no device. Records stay in memory
until `take()` returns them. Nothing is written to the profiler's trace:
a `record_function` range would also appear on the device's timeline,
where it would count as device work.

The record is the process's, as the profiler is: spans nest by the order
in which they open, so one thread records at a time.
"""
from __future__ import annotations

import time
from array import array
from typing import NamedTuple

from torch.autograd import profiler as _profiler


class Span(NamedTuple):
    """One recorded span. `parent` is the index of the span open around it
    in the same `take()` (-1: none); `image` the `new_image()` count of
    the render() call it belongs to and `launch` the launch index within
    that render (-1: outside one)."""
    name: str
    start: int   # ns, time.time_ns()
    end: int
    parent: int
    image: int
    launch: int


# the record, one column a field: arrays of ints and a list of names, so
# that the garbage collector tracks no object a span (a list a span made
# a full collection stall a long traced run for 60-80 ms)
_names: list = []
_start, _end, _parent, _image, _launch = (array("q") for _ in range(5))
_open: list = []         # indices of the open spans, innermost last
_where = [-1, -1]        # image, launch of the spans that open now
_images = [0]            # render() calls in this process


def recording() -> bool:
    """Whether a torch.profiler session records in this process."""
    return _profiler._is_profiler_enabled


def new_image() -> int:
    """The id of a new image: the count of calls so far, render()'s."""
    _images[0] += 1
    return _images[0]


class _Off:
    """The span of a site while nothing records: does nothing."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "image", "launch", "i", "saved")

    def __init__(self, name: str, image, launch):
        self.name, self.image, self.launch = name, image, launch

    def __enter__(self):
        self.saved = (_where[0], _where[1])
        if self.image is not None:
            _where[0], _where[1] = self.image, -1
        if self.launch is not None:
            _where[1] = self.launch
        self.i = len(_names)
        _names.append(self.name)
        _parent.append(_open[-1] if _open else -1)
        _image.append(_where[0])
        _launch.append(_where[1])
        _end.append(0)
        _open.append(self.i)
        _start.append(time.time_ns())
        return None

    def __exit__(self, *exc) -> bool:
        _end[self.i] = time.time_ns()
        _open.pop()
        _where[0], _where[1] = self.saved
        return False


def span(name: str, image: int | None = None, launch: int | None = None):
    """A context manager that records the step it encloses as span `name`
    while a profiler records. `image` (a `new_image()` id) or `launch`
    (an index) sets what the span and the spans inside it belong to."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, image, launch)


def take() -> list:
    """The spans recorded since the last call, in the order they opened,
    as `Span`s; the record is then empty. Call it with no span open."""
    cols = (_start, _end, _parent, _image, _launch)
    out = [Span(*r) for r in zip(_names, *cols)]
    del _names[:]
    for col in cols:
        del col[:]
    return out


def chrome_events(recorded: list, base_ns: int, pid: str = "render spans"
                  ) -> list:
    """`recorded` spans as Chrome trace events on a process row of their
    own: complete events ("X", µs from `base_ns`, the trace's
    `baseTimeNanoseconds`) on one thread, with the row's name."""
    evs = [{"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
            "args": {"name": pid}}]
    for s in recorded:
        evs.append({"ph": "X", "name": s.name, "pid": pid, "tid": 0,
                    "ts": (s.start - base_ns) / 1e3,
                    "dur": (s.end - s.start) / 1e3,
                    "args": {"image": s.image, "launch": s.launch}})
    return evs
