"""The one-device RMSD k-centers loop (``engine._kcenters_loop``, kernel 1
on a card, its plain version on the CPU) as a user reaches it:
``KCenters(metric='rmsd', random_first_center=True).fit(X)`` on a tensor,
with no ``device=`` or ``mesh=``.

- On the CPU, on seeded basin frames: every center and label the
  benchmark's float64 reference's (``msmbench/reference/kcenters.py``),
  the distances within its bar; one ``enspara/kcenters.loop`` and one
  ``enspara/kcenters.results`` span a fit, the chunks inside the loop;
  ``kcenters_device_fused.n_tiles_skipped`` equal to a recount by the
  rule (tiles whose max is ``<= md/2``) one iteration at a time.
- On a card (``cuda``, skipped without one): no copy of the frames
  between host and card during ``fit`` of a card-resident tensor; the
  counter equal to the recount from kernel 1's own state, and the fit's
  results bit for bit those of the loop stepped one iteration at a time,
  which counts nothing. On the card machine, run with ``python -m pytest
  --noconftest -m cuda tests/test_torch_kcenters_one_card.py``.
"""

import json
import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from enspara_tpu_torch.cluster import KCenters, engine
from enspara_tpu_torch.ops import kcenters_step

# float32 QCP against the float64 reference: the msd comes from
# gsum - 2 lambda_max in float32 (a few ulp of gsum / n_atoms) and the
# Newton epilogue stops within 1e-4 in msd for structures that barely
# align, the bar of tests/test_torch_qcp_converged.py
MSD_BAR = 1e-4


@pytest.fixture(autouse=True)
def _cpu_platform(monkeypatch):
    """Host inputs run on the CPU in these tests; torch on one thread
    (the tier-1 run puts several test workers on one host's cores)."""
    monkeypatch.setenv('ENSPARA_TPU_PLATFORM', 'cpu')
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (torch.cuda.is_available() is '
                    'False)')
    monkeypatch.delenv('ENSPARA_TPU_PLATFORM')
    return torch.device('cuda', 0)


def basin_frames(seed, n, device='cpu'):
    """The benchmark's basin frames (``msmbench/data/basins.py``) of 35
    atoms, WW's width, as a tensor on ``device``."""
    from msmbench.data import basins
    return basins.frames(seed, n, 35, n_basins=60, dwell=64, noise=0.02,
                         device=device)


def fit(X, k, seed):
    return KCenters(metric='rmsd', n_clusters=k, random_first_center=True,
                    random_state=seed).fit(X).result_


@pytest.mark.parametrize('seed', [25, 2500, 2 ** 31 + 25])
def test_fit_on_a_tensor_equals_the_reference(seed):
    from msmbench.reference import kcenters as ref_kc
    from msmbench.reference.qcp import Frames
    X = basin_frames(seed, 3000)
    res = fit(X, 24, seed)
    first = np.random.default_rng(seed).integers(len(X))
    want, labels, dist, _ = ref_kc.kcenters(Frames(X), 24, first)
    np.testing.assert_array_equal(res.center_indices, want)
    np.testing.assert_array_equal(res.assignments, labels.numpy())
    msd = np.asarray(res.distances) ** 2
    assert np.abs(msd - dist.numpy() ** 2).max() <= MSD_BAR


def _spans(events, name):
    return [e for e in events if e.name == name]


@pytest.mark.parametrize('k', [24, 150])
def test_one_loop_and_one_results_span_a_fit(k):
    X = basin_frames(7, 3000)
    plain = fit(X, k, 7)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = fit(X, k, 7)
    events = list(prof.events())
    np.testing.assert_array_equal(res.center_indices, plain.center_indices)
    np.testing.assert_array_equal(res.distances, plain.distances)
    loop, = _spans(events, 'enspara/kcenters.loop')
    results, = _spans(events, 'enspara/kcenters.results')
    assert loop.time_range.end <= results.time_range.start
    chunks = _spans(events, 'enspara/kcenters.chunk')
    assert len(chunks) == -(-(k - 1) // engine.CHUNK)
    assert all(loop.time_range.start <= c.time_range.start
               and c.time_range.end <= loop.time_range.end for c in chunks)


def stepped(X, k, device):
    """K-centers from frame 0 stepped one iteration a call of the chunk
    kernel (or its plain version), counting before each iteration the
    tiles whose max is ``<= md/2`` from the state it leaves: ``(count,
    centers, distances, labels)`` of the real frames."""
    prep = engine.prepare_rmsd_frames(X, device=device)
    k_max, k, cutoff, dist, assig = engine._loop_start(prep, k, None, None,
                                                       None, None)
    state = kcenters_step.start_state(dist[0][None], assig[0][None],
                                      prep.frames_r.shape[0], prep.tile, 0,
                                      k, cutoff)
    n_tiles = prep.frames_r.shape[1] // prep.tile
    count, centers = 0, []
    while True:
        _, md, i = state.scalars()
        if i >= k or not md > cutoff:
            break
        if math.isfinite(md):
            count += int((state.tmax[0, :n_tiles] <= 0.5 * md).sum())
        centers.append(int(kcenters_step.kcenters_chunk(prep, state, 1)[0][0]))
    n = len(X)
    return (count, np.asarray(centers), state.dist[0, :n].cpu().numpy(),
            state.assig[0, :n].cpu().numpy())


def _counted_fit(X, k):
    engine.kcenters_device_fused.n_tiles_skipped = -1
    res = engine.kcenters_device_fused(X, n_clusters=k)
    return res, engine.kcenters_device_fused.n_tiles_skipped


def test_tiles_skipped_equal_the_recount():
    """150 centers, three chunks: the counter sums each chunk's counts
    in its own slots, the slots past a chunk's stop read as none."""
    X = basin_frames(11, 4000)
    res, counted = _counted_fit(X, 150)
    count, centers, dist, assig = stepped(X, 150, 'cpu')
    assert counted == count > 0
    np.testing.assert_array_equal(res.center_indices, centers)
    np.testing.assert_array_equal(res.distances, dist.astype(np.float64))
    np.testing.assert_array_equal(res.assignments, assig)


# ---------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_fit_copies_no_frames(cuda, tmp_path):
    """200,000 card-resident frames: the bytes that cross between host
    and card during ``fit`` (the labels and distances fetched, the
    centers' frames) stay under a tenth of the frames' bytes."""
    n, k = 200_000, 100
    X = basin_frames(13, n, cuda)
    fit(X, k, 13)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fit(X, k, 13)
        torch.cuda.synchronize()
    path = str(tmp_path / 'trace.json')
    prof.export_chrome_trace(path)
    with open(path) as f:
        evs = json.load(f)['traceEvents']
    copies = [int(e.get('args', {}).get('bytes', 0)) for e in evs
              if e.get('cat') == 'gpu_memcpy'
              and ('HtoD' in e['name'] or 'DtoH' in e['name'])]
    assert copies and sum(copies) < X.numel() * 4 // 10


@pytest.mark.cuda
def test_cuda_tiles_skipped_equal_the_recount(cuda):
    """Kernel 1 at 300,000 frames, 200 centers: the counter equals the
    recount from the kernel's own state one iteration at a time, and
    the fit's results are that stepped loop's bit for bit."""
    X = basin_frames(17, 300_000, cuda)
    before = kcenters_step.kcenters_chunk.n_launches
    res, counted = _counted_fit(X, 200)
    assert kcenters_step.kcenters_chunk.n_launches > before
    count, centers, dist, assig = stepped(X, 200, cuda)
    assert counted == count > 0
    np.testing.assert_array_equal(res.center_indices, centers)
    np.testing.assert_array_equal(res.distances, dist.astype(np.float64))
    np.testing.assert_array_equal(res.assignments, assig)
