"""``mesh.collectives``: the collectives over the processes that rank 0
enqueues inside its sharded k-centers loops per k-centers iteration: the
number of the program's ``enspara/mesh.*`` spans that start inside an
``enspara/kcenters.sharded`` span, over ``n_clusters - 1`` iterations a
loop."""

LOOP = 'enspara/kcenters.sharded'
PREFIX = 'enspara/mesh.'


def read(trace):
    loops = [e for e in trace.cpu if e.name == LOOP]
    n = sum(1 for e in trace.cpu if e.name.startswith(PREFIX)
            and any(s.start <= e.start <= s.end for s in loops))
    if not loops or not n:
        return None
    return n / (len(loops) * (trace.config['cluster']['n_clusters'] - 1))
