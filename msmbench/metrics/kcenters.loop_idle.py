"""``kcenters.loop_idle``: the share of the one-card k-centers loops in
which the card runs no kernel, copy or set: 100 minus the union of the
profiler's device intervals, clipped to the program's
``enspara/kcenters.loop`` spans (one a ``kcenters_device_fused`` call on
one device, around its chunks and their host reads), over those spans'
summed length, in percent. None where the program has no such span."""

from msmbench.harness.trace import Event

NAME = 'enspara/kcenters.loop'


def read(trace):
    spans = [e for e in trace.cpu if e.name == NAME]
    if not spans or not trace.gpu:
        return None
    length = sum(s.end - s.start for s in spans)
    clipped = [Event(e.name, max(e.start, s.start), min(e.end, s.end))
               for s in spans for e in trace.gpu
               if e.start < s.end and e.end > s.start]
    return 100.0 * (1.0 - trace.busy_union_us(clipped) / length)
