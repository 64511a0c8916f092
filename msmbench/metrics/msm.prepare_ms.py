"""``msm.prepare_ms``: milliseconds per job of the MSM tail's host
preparation, the summed length of the program's ``enspara/msm.prepare``
spans (``implied_timescales_batched`` from its entry to its first
launch: the padded labels, the checks, the copies to the card) over the
traced jobs."""

NAME = 'enspara/msm.prepare'


def read(trace):
    jobs = len(trace.span_list('job'))
    evs = [e for e in trace.cpu if e.name == NAME]
    if not jobs or not evs:
        return None
    return 1e-3 * sum(e.end - e.start for e in evs) / jobs
