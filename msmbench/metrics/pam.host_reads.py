"""``pam.host_reads``: the PAM sweeps' synchronising reads of device
scalars per job, the number of the program's ``enspara/pam.read`` spans
(one for each count of ``_pam_sweeps.n_host_syncs``) over the traced
jobs."""

NAME = 'enspara/pam.read'


def read(trace):
    jobs = len(trace.span_list('job'))
    n = sum(1 for e in trace.cpu if e.name == NAME)
    if not jobs or not n:
        return None
    return n / jobs
