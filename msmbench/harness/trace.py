"""Spans around the benchmark's calls into each layer, and the reading of
the profiler's trace.

A span names one layer's call inside one job (``cluster``, ``assign``,
``msm``; ``job`` around the whole job). With tracing off a span does
nothing. With tracing on it is a ``torch.profiler.record_function``
range named ``msmbench/<name>``, so that the profiler's events can be
sorted into spans on the profiler's own clock, and its host time ends
after ``torch.cuda.synchronize()`` (outside the range, so that the
harness's own synchronise is not counted as the program's).

:class:`Trace` is what every per-layer metric reader gets: the spans,
the host-side and device-side events of the profiled window, and the
cell's configuration and traffic parameters.
"""

import bisect
import contextlib
import time
from collections import defaultdict, namedtuple

PREFIX = 'msmbench/'

Event = namedtuple('Event', 'name start end')       # microseconds
Span = namedtuple('Span', 'name start end host_s')  # profiler us, host s


class Spans:
    """Host-clock spans, recorded only when ``on``."""

    def __init__(self, on=False, sync=None):
        self.on = on
        self.sync = sync or (lambda: None)
        self.host = []          # (name, host seconds)

    @contextlib.contextmanager
    def __call__(self, name):
        if not self.on:
            yield
            return
        import torch.profiler
        tick = time.perf_counter()
        with torch.profiler.record_function(PREFIX + name):
            yield
        self.sync()
        self.host.append((name, time.perf_counter() - tick))


def _union(intervals):
    """Sorted, merged copy of ``(start, end)`` intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _clip_len(merged, lo, hi):
    return sum(max(0.0, min(e, hi) - max(s, lo)) for s, e in merged)


class Trace:
    """One traced window: ``cpu`` and ``gpu`` are lists of
    :data:`Event` (profiler microseconds), ``spans`` the harness's
    ranges in the same clock with their host seconds."""

    def __init__(self, cpu, gpu, spans, config, traffic):
        self.cpu = sorted(cpu, key=lambda e: e.start)
        self.gpu = sorted(gpu, key=lambda e: e.start)
        self.spans = spans
        self.config = config
        self.traffic = traffic
        jobs = self.span_list('job')
        self.window = (jobs[0].start, jobs[-1].end) if jobs else (0.0, 0.0)
        self._busy = _union((e.start, e.end) for e in self.gpu)

    @property
    def window_s(self):
        return (self.window[1] - self.window[0]) * 1e-6

    @property
    def busy_s(self):
        return _clip_len(self._busy, *self.window) * 1e-6

    def span_list(self, name):
        return [s for s in self.spans if s.name == name]

    def span_mean_ms(self, name):
        """Mean host milliseconds of a span over the jobs that have it;
        None where no job has it."""
        spans = self.span_list(name)
        if not spans:
            return None
        return 1e3 * sum(s.host_s for s in spans) / len(spans)

    def inside(self, events, name):
        """The events that start inside a span of ``name``."""
        spans = self.span_list(name)
        return [e for e in events
                if any(s.start <= e.start <= s.end for s in spans)]

    def busy_union_us(self, events):
        """Length of the union of the events' intervals, microseconds."""
        return sum(e - s for s, e in _union((x.start, x.end)
                                            for x in events))

    def device_ops(self, top=10):
        """The device operations that took most time: ``[[name,
        seconds], ...]``, largest first."""
        total = defaultdict(float)
        lo, hi = self.window
        for e in self.gpu:
            total[e.name[:120]] += max(0.0, min(e.end, hi)
                                       - max(e.start, lo)) * 1e-6
        return [[n, s] for n, s in sorted(total.items(),
                                          key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top=10):
        """Where the device idled in the window, summed by what the host
        was doing at each gap's middle (the shortest host event holding
        it, with the innermost harness span): ``[[name, seconds]]``."""
        lo, hi = self.window
        gaps, cursor = [], lo
        for s, e in self._busy:
            if s > cursor and cursor < hi:
                gaps.append((cursor, min(s, hi)))
            cursor = max(cursor, e)
        if cursor < hi:
            gaps.append((cursor, hi))
        starts = [e.start for e in self.cpu]
        span_evs = sorted((s.start, s.end, s.name) for s in self.spans)
        total = defaultdict(float)
        for g0, g1 in gaps:
            mid = 0.5 * (g0 + g1)
            best = None
            i = bisect.bisect_right(starts, mid)
            for e in reversed(self.cpu[max(0, i - 400):i]):
                if e.end >= mid and not e.name.startswith(PREFIX) and (
                        best is None or e.end - e.start < best.end
                        - best.start):
                    best = e
            layer = [n for s, e, n in span_evs if s <= mid <= e
                     and n != 'job']
            where = (layer[-1] if layer else 'between spans')
            what = best.name[:80] if best else 'no host event'
            total['%s: %s' % (where, what)] += (g1 - g0) * 1e-6
        return [[n, s] for n, s in sorted(total.items(),
                                          key=lambda kv: -kv[1])[:top]]


def from_profiler(prof, spans_host, config, traffic):
    """A :class:`Trace` from a finished ``torch.profiler.profile``: CUDA
    events (kernels, copies, sets) go to ``gpu``, every other event to
    ``cpu``; the ``msmbench/`` ranges become spans, paired in order with
    the host seconds ``spans_host`` recorded for them."""
    from torch.autograd import DeviceType
    cpu, gpu, ranges = [], [], []
    for e in prof.events():
        ev = Event(e.name, float(e.time_range.start),
                   float(e.time_range.end))
        if e.device_type == DeviceType.CUDA:
            # a span's range is mirrored on the device's timeline as an
            # annotation, not as device work
            if not e.name.startswith(PREFIX):
                gpu.append(ev)
        elif e.name.startswith(PREFIX):
            ranges.append(ev)
        else:
            cpu.append(ev)
    ranges.sort(key=lambda e: e.end)      # spans close in this order
    by_name = defaultdict(list)
    for name, host_s in spans_host:
        by_name[name].append(host_s)
    spans = []
    for ev in ranges:
        name = ev.name[len(PREFIX):]
        host_s = by_name[name].pop(0) if by_name[name] else None
        spans.append(Span(name, ev.start, ev.end, host_s))
    return Trace(cpu, gpu, spans, config, traffic)
