"""``kcenters.results_ms``: host milliseconds a traced job spends in the
program's ``enspara/kcenters.results`` spans (the fetch of a k-centers
call's labels, distances and centers to the host after its loop, one
card or sharded; on several cards, rank 0's), summed over the traced
jobs and divided by their number. None where the program has no such
span."""

NAME = 'enspara/kcenters.results'


def read(trace):
    jobs = len(trace.span_list('job'))
    spans = [e for e in trace.cpu if e.name == NAME]
    if not jobs or not spans:
        return None
    return 1e-3 * sum(e.end - e.start for e in spans) / jobs
