"""The benchmark's command: one run of one cell.

A run makes the cell's data from ``--seed`` and warms every shape with
one job (set-up), then runs jobs back to back for ``--seconds`` (a
closed loop with one client: each job starts when the last ended; the
job that crosses ``--seconds`` is finished and counted, and the window
ends with it), and prints one JSON line. With ``--trace 1`` it runs the
traffic's ``trace_jobs`` jobs under ``torch.profiler`` instead, with the
harness's spans on, and reports the cell's per-layer metrics. Either
way it then judges a sample of the jobs, drawn from the seed, against
the plain reference under ``msmbench/reference`` and sets ``correct``.

A cell on several chips starts one process a card (``CUDA_VISIBLE_DEVICES
= rank``), joined over ``127.0.0.1`` at a free port; rank 0 decides when
the window ends, and this process prints rank 0's line last, with the
largest memory peak over the cards and the judge's numbers over every
rank's stripe of the frames.

A run with no card, or fewer than the cell asks for, fails and prints no
result; so does one that finds ``jax``, ``jaxlib``, ``flax`` or
``enspara_tpu`` among the loaded modules once the window has closed.
"""

import argparse
import gc
import json
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np

from . import spec
from .trace import Spans, from_profiler

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'enspara_tpu')
CHILD_TIMEOUT_S = 340
THREADS = 4


def parse(argv):
    p = argparse.ArgumentParser(prog='msmbench/run.py')
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    # one rank of a cell on several cards, started by the launcher
    p.add_argument('--rank', type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument('--world', type=int, default=1, help=argparse.SUPPRESS)
    p.add_argument('--t0', type=float, default=None, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def log(msg):
    print('msmbench: %s' % msg, file=sys.stderr, flush=True)


def forbidden_modules():
    """Whole top-level names of loaded modules that the run must not
    hold."""
    return sorted({m.split('.')[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def job_random_state(seed, index):
    """The ``random_state`` of job ``index`` of a run (0 is the warm
    job): a 31-bit integer drawn from the run's seed."""
    ss = np.random.SeedSequence([int(seed) & (2 ** 64 - 1), int(index)])
    return int(ss.generate_state(1, np.uint32)[0] >> 1)


def check_sample(seed, n_jobs, k):
    """Which of the window's ``n_jobs`` jobs the judge reads: ``k`` of
    them drawn from the seed."""
    rng = np.random.default_rng([int(seed) & (2 ** 64 - 1), 7])
    k = min(k, n_jobs)
    return sorted(rng.choice(n_jobs, size=k, replace=False).tolist())


def power_limits():
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader,nounits'], capture_output=True,
            text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    if out.returncode != 0:
        return None
    lims = []
    for line in out.stdout.strip().splitlines():
        try:
            lims.append(float(line.rsplit(',', 1)[1]))
        except (IndexError, ValueError):
            lims.append(None)
    return lims


class Context:
    """What a job kind's ``setup`` gets: the cell's configuration and
    traffic, the run's seed, the device, this process's rank in a job
    of ``world`` processes, the spans, and ``mesh``: None, so that the
    job kind joins the job itself, or a mesh given by a test."""

    def __init__(self, config, traffic, seed, device, spans, rank=0,
                 world=1, mesh=None):
        self.config = config
        self.traffic = traffic
        self.seed = seed
        self.device = device
        self.spans = spans
        self.rank = rank
        self.world = world
        self.mesh = mesh


def verdict(numbers, limits):
    """``(correct, check)``: every number at or below its limit."""
    check, correct = {}, True
    for name, value in numbers.items():
        limit = limits[name]
        ok = value == value and value <= limit
        correct &= ok
        check[name] = {'value': value, 'limit': limit}
    return correct, check


def combine_numbers(kind, per_rank, limits):
    """The judge's numbers of each picked job over every rank's
    partials, then the largest of each over the jobs."""
    n_jobs = len(per_rank[0])
    worst, failed = {}, 0
    for j in range(n_jobs):
        nums = kind.numbers([rank[j] for rank in per_rank])
        ok, _ = verdict(nums, limits)
        failed += not ok
        for k, v in nums.items():
            if k not in worst or not v <= worst[k]:     # NaN stays
                worst[k] = v
    return worst, failed


def require_cards(n):
    """cuda:0 of this process, or ``SystemExit`` when torch sees fewer
    than ``n`` cards: a measurement never falls back to the CPU."""
    import torch
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < n:
        raise SystemExit('msmbench: needs %d CUDA card(s); torch sees %d'
                         % (n, have))
    device = torch.device('cuda', 0)
    torch.cuda.set_device(device)
    return device


class Card:
    """The device calls of a run: on a card, CUDA's; on the CPU (the
    harness's own tests) stand-ins that read zero memory."""

    def __init__(self, device):
        import torch
        self.cuda = device.type == 'cuda'
        self.torch = torch
        self.device = device

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize()

    def peak(self):
        return self.torch.cuda.max_memory_allocated() if self.cuda else 0

    def reset_peak(self):
        if self.cuda:
            self.torch.cuda.reset_peak_memory_stats()

    def free(self):
        gc.collect()
        if self.cuda:
            self.torch.cuda.empty_cache()

    def name(self):
        return (self.torch.cuda.get_device_name(self.device) if self.cuda
                else 'cpu')


def run_rank(args, t0, bench, cell, cfg, trf, kind, device, mesh=None):
    """Set-up, window and judge in this process on ``device``; returns
    the rank's report (a dict) or raises."""
    import torch
    torch.set_num_threads(THREADS)
    card = Card(device)
    rank = args.rank or 0
    spans = Spans(on=bool(args.trace) and rank == 0, sync=card.sync)
    ctx = Context(cfg, trf, args.seed, device, spans, rank, args.world,
                  mesh)
    state = kind.setup(ctx)
    quiet = Spans(on=False)
    kind.run(state, job_random_state(args.seed, 0), quiet)
    card.sync()
    setup_peak = card.peak()
    card.reset_peak()

    def go_on(flag):
        """Rank 0's decision, the same on every rank."""
        if args.world == 1:
            return flag
        import torch.distributed as dist
        t = torch.tensor([int(flag)])
        dist.broadcast(t, src=0)
        return bool(t.item())

    outputs = []
    report = {}
    start = time.time()
    setup_s = start - t0
    log('rank %d: set-up %.3f s' % (rank, setup_s))
    if args.trace:
        n_trace = int(trf['trace_jobs'])
        prof = None
        if rank == 0:
            from torch.profiler import ProfilerActivity, profile
            prof = profile(activities=[ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if card.cuda else []))
            prof.__enter__()
        for j in range(n_trace):
            with spans('job'):
                outputs.append(kind.run(
                    state, job_random_state(args.seed, j + 1), spans))
        card.sync()
        if prof is not None:
            prof.__exit__(None, None, None)
            tr = from_profiler(prof, spans.host, cfg, trf)
            del prof
            report.update(traced(bench, cell, tr))
    else:
        while True:
            outputs.append(kind.run(
                state, job_random_state(args.seed, len(outputs) + 1), quiet))
            if not go_on(time.time() - start < args.seconds):
                break
        card.sync()
        window = time.time() - start
        report['job_s'] = window / len(outputs)
    peak = card.peak()
    report.update(setup_s=setup_s, n_jobs=len(outputs), window_peak=peak,
                  memory_peak=max(peak, setup_peak), kind=card.name())

    log('rank %d: %d jobs in %.3f s' % (rank, len(outputs),
                                         time.time() - start))
    # the judge: after the window, with the program's state dropped
    card.free()
    tick = time.time()
    picked = check_sample(args.seed, len(outputs), int(trf['check_jobs']))
    report['partials'] = [kind.judge(state, outputs[i], ctx) for i in picked]
    log('rank %d: judged job(s) %s in %.3f s' % (rank, picked,
                                                 time.time() - tick))
    report['forbidden'] = forbidden_modules()
    return report


def traced(bench, cell, tr):
    """What a traced run reports from its :class:`~.trace.Trace`: the
    per-layer metrics whose readers find something, the device's busy
    and window seconds, and the breakdown."""
    metrics = {}
    for m in spec.per_layer(bench, cell['name']):
        value = spec.metric_reader(m['name']).read(tr)
        if value is not None:
            metrics[m['name']] = {'value': value, 'unit': m['unit']}
    return {'trace_metrics': metrics, 'busy_s': tr.busy_s,
            'window_s': tr.window_s,
            'breakdown': {'device_ops': tr.device_ops(),
                          'idle_gaps': tr.idle_gaps()}}


def end_to_end_line(bench, cell, report):
    values = {'job_s': report['job_s'], 'setup_s': report['setup_s'],
              'peak_device_gib': report['window_peak'] / 2 ** 30}
    return {m['name']: {'value': values[m['name']], 'unit': m['unit']}
            for m in spec.end_to_end(bench, cell['name'])}


def emit(bench, cell, args, report, numbers, failed, limits, n_cards):
    """Print the judge's numbers on standard error and the result line
    on standard output, and return the exit code."""
    bad = sorted(set(report['forbidden']) | set(forbidden_modules()))
    if bad:
        log('refusing to report: loaded %s' % ', '.join(bad))
        return 3
    correct, check = verdict(numbers, limits)
    line = {
        'correct': bool(correct),
        'attempted': report['n_jobs'],
        'failed': failed,
        'metrics': (report['trace_metrics'] if args.trace
                    else end_to_end_line(bench, cell, report)),
        'device': {'platform': 'gpu', 'kind': report['kind'],
                   'count': n_cards,
                   'memory_peak_bytes': report['memory_peak'],
                   'power_limit_w': power_limits()},
    }
    if args.trace:
        line['device'].update(busy_s=report['busy_s'],
                              window_s=report['window_s'])
        line['breakdown'] = report['breakdown']
    line['check'] = check
    for name, c in check.items():
        log('check %s = %r (limit %r)%s' % (
            name, c['value'], c['limit'],
            '' if c['value'] <= c['limit'] else '  FAILED'))
    print(json.dumps(line), flush=True)
    return 0


def free_port():
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def launch(args, t0, cell):
    """Start one process a card, wait for all, and return their
    reports (rank order); None where any failed."""
    import torch
    want = cell['chips']
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < want:
        log('needs %d CUDA cards; torch sees %d' % (want, have))
        return None
    port = free_port()
    procs = []
    for r in range(want):
        env = dict(os.environ, CUDA_VISIBLE_DEVICES=str(r),
                   ENSPARA_TPU_COORDINATOR='127.0.0.1:%d' % port,
                   ENSPARA_TPU_NUM_PROCESSES=str(want),
                   ENSPARA_TPU_PROCESS_ID=str(r),
                   OMP_NUM_THREADS=str(THREADS))
        env.pop('ENSPARA_TPU_LOCAL_SHARDS', None)
        cmd = [sys.executable, os.path.join(spec.BENCH_DIR, 'run.py'),
               '--workload', args.workload, '--seed', str(args.seed),
               '--seconds', repr(args.seconds), '--trace', str(args.trace),
               '--rank', str(r), '--world', str(want), '--t0', repr(t0)]
        procs.append(subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                      text=True))
    # read every rank's output as it comes, and end the job as soon as
    # one rank fails: the others would wait in a collective
    outs = [[] for _ in procs]
    readers = [threading.Thread(target=lambda p=p, o=o: o.append(
        p.stdout.read()), daemon=True) for p, o in zip(procs, outs)]
    for t in readers:
        t.start()
    deadline = time.time() + CHILD_TIMEOUT_S
    ok = True
    try:
        while ok and any(p.poll() is None for p in procs):
            for r, p in enumerate(procs):
                if p.poll() not in (None, 0):
                    log('rank %d exited with %d' % (r, p.returncode))
                    ok = False
            if time.time() > deadline:
                log('the ranks did not finish in %d s' % CHILD_TIMEOUT_S)
                ok = False
            time.sleep(0.1)
        ok = ok and all(p.returncode == 0 for p in procs)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        for t in readers:
            t.join(timeout=10)
    if not ok:
        return None
    outs = [''.join(o) for o in outs]
    reports = []
    for r, out in enumerate(outs):
        lines = [x for x in out.strip().splitlines() if x.startswith('{')]
        if not lines:
            log('rank %d printed no report' % r)
            return None
        reports.append(json.loads(lines[-1]))
    return reports


def require_program():
    """The program under test, ``enspara_tpu_torch``, from this
    checkout; ``SystemExit`` where the checkout does not hold it."""
    try:
        import enspara_tpu_torch
    except ImportError as e:
        raise SystemExit('msmbench: the program is missing: %s' % e)
    where = os.path.dirname(os.path.abspath(enspara_tpu_torch.__file__))
    if os.path.dirname(where) != spec.ROOT:
        raise SystemExit('msmbench: enspara_tpu_torch comes from %s, not '
                         'from this checkout' % where)


def main(argv, t0):
    args = parse(argv)
    t0 = args.t0 if args.t0 is not None else t0
    require_program()
    bench = spec.load_benchmark()
    cell = spec.workload(bench, args.workload)
    cfg = spec.config(cell['config'])
    trf = spec.traffic(cell['traffic'])
    kind = spec.job_kind(trf['job'])
    limits = trf['limits']

    if cell['chips'] > 1 and args.rank is None:
        reports = launch(args, t0, cell)
        if reports is None:
            return 1
        lead = reports[0]
        lead['memory_peak'] = max(r['memory_peak'] for r in reports)
        lead['window_peak'] = max(r['window_peak'] for r in reports)
        lead['forbidden'] = sorted({m for r in reports
                                    for m in r['forbidden']})
        numbers, failed = combine_numbers(
            kind, [r['partials'] for r in reports], limits)
        return emit(bench, cell, args, lead, numbers, failed, limits,
                    cell['chips'])

    device = require_cards(1 if args.rank is not None else cell['chips'])
    report = run_rank(args, t0, bench, cell, cfg, trf, kind, device)
    if args.rank is not None:
        # a rank's report goes to the launcher
        print(json.dumps(report), flush=True)
        return 0
    numbers, failed = combine_numbers(kind, [report['partials']], limits)
    return emit(bench, cell, args, report, numbers, failed, limits, 1)
