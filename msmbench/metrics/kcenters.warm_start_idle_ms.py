"""``kcenters.warm_start_idle_ms``: milliseconds a traced job in which
rank 0's card runs no kernel, copy or set inside the program's
``enspara/kcenters.warm_start`` spans (the k-centers warm start: the
assignment to the init centers, the search for their frames and the
hand-over to the loop): the spans' summed length less the union of the
profiler's device intervals clipped to them, over the traced jobs. None
where the program has no such span."""

from msmbench.harness.trace import Event

NAME = 'enspara/kcenters.warm_start'


def read(trace):
    jobs = len(trace.span_list('job'))
    spans = [e for e in trace.cpu if e.name == NAME]
    if not jobs or not spans or not trace.gpu:
        return None
    length = sum(s.end - s.start for s in spans)
    clipped = [Event(e.name, max(e.start, s.start), min(e.end, s.end))
               for s in spans for e in trace.gpu
               if e.start < s.end and e.end > s.start]
    return 1e-3 * (length - trace.busy_union_us(clipped)) / jobs
