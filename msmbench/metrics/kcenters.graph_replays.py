"""``kcenters.graph_replays``: the CUDA graph replays of rank 0's sharded
k-centers loops, per loop: the number of the program's
``enspara/kcenters.replay`` spans that start inside an
``enspara/kcenters.sharded`` span, over the number of those spans. None
where the program replays no graph."""

LOOP = 'enspara/kcenters.sharded'
REPLAY = 'enspara/kcenters.replay'


def read(trace):
    loops = [e for e in trace.cpu if e.name == LOOP]
    n = sum(1 for e in trace.cpu if e.name == REPLAY
            and any(s.start <= e.start <= s.end for s in loops))
    if not loops or not n:
        return None
    return n / len(loops)
