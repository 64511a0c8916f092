"""``mesh.collective_ms``: host milliseconds that rank 0 spends in the
program's collective spans (``enspara/mesh.all_reduce``,
``enspara/mesh.all_gather``: the enqueueing of one collective over the
processes) that start inside its sharded k-centers loops
(``enspara/kcenters.sharded``), per k-centers iteration
(``n_clusters - 1`` a loop)."""

LOOP = 'enspara/kcenters.sharded'
PREFIX = 'enspara/mesh.'


def read(trace):
    loops = [e for e in trace.cpu if e.name == LOOP]
    evs = [e for e in trace.cpu if e.name.startswith(PREFIX)
           and any(s.start <= e.start <= s.end for s in loops)]
    if not loops or not evs:
        return None
    iters = len(loops) * (trace.config['cluster']['n_clusters'] - 1)
    return 1e-3 * sum(e.end - e.start for e in evs) / iters
