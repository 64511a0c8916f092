"""``pam.read_wait_ms``: milliseconds per job that the PAM sweeps' host
spends in its synchronising reads, the summed length of the program's
``enspara/pam.read`` spans (the wait for the card plus the copy) over
the traced jobs."""

NAME = 'enspara/pam.read'


def read(trace):
    jobs = len(trace.span_list('job'))
    evs = [e for e in trace.cpu if e.name == NAME]
    if not jobs or not evs:
        return None
    return 1e-3 * sum(e.end - e.start for e in evs) / jobs
