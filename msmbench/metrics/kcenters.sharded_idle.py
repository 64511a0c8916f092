"""``kcenters.sharded_idle``: the share of rank 0's sharded k-centers
loops in which its card runs no kernel, copy or set: 100 minus the union
of the profiler's device intervals, clipped to the program's
``enspara/kcenters.sharded`` spans, over those spans' summed length, in
percent."""

from msmbench.harness.trace import Event

NAME = 'enspara/kcenters.sharded'


def read(trace):
    spans = [e for e in trace.cpu if e.name == NAME]
    if not spans or not trace.gpu:
        return None
    length = sum(s.end - s.start for s in spans)
    clipped = [Event(e.name, max(e.start, s.start), min(e.end, s.end))
               for s in spans for e in trace.gpu
               if e.start < s.end and e.end > s.start]
    return 100.0 * (1.0 - trace.busy_union_us(clipped) / length)
