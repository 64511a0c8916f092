"""``khybrid.kcenters_ms``: milliseconds of k-hybrid's k-centers stage
per job, the summed length of the program's ``enspara/khybrid.kcenters``
spans (host time on the profiler's clock, ending in the stage's host
fetch of labels and distances) over the traced jobs."""

NAME = 'enspara/khybrid.kcenters'


def read(trace):
    jobs = len(trace.span_list('job'))
    evs = [e for e in trace.cpu if e.name == NAME]
    if not jobs or not evs:
        return None
    return 1e-3 * sum(e.end - e.start for e in evs) / jobs
