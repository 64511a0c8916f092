"""``khybrid.pam_ms``: milliseconds of k-hybrid's PAM stage per job, the
summed length of the program's ``enspara/khybrid.pam`` spans (host time
on the profiler's clock, ending in the stage's host fetch of medoids,
labels and distances) over the traced jobs."""

NAME = 'enspara/khybrid.pam'


def read(trace):
    jobs = len(trace.span_list('job'))
    evs = [e for e in trace.cpu if e.name == NAME]
    if not jobs or not evs:
        return None
    return 1e-3 * sum(e.end - e.start for e in evs) / jobs
