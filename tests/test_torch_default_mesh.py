"""``mesh=None`` in the port: the JAX package's default mesh.

With the port's ``frame_mesh`` patched to return four CPU shards (the
stand-in for four visible cards), each entry point whose JAX counterpart
takes the default mesh runs over it when called with no ``mesh=`` and no
``device=``: the results equal the explicit 4-shard mesh bit for bit and
the JAX package's ``mesh=None`` over its 8 XLA CPU devices at the parity
bars (indices and labels exactly, RMSD distances on
``assert_rmsd_close``'s msd bar, feature distances within 1e-5). The
PAM sweeps of both packages draw the JAX package's bits. A job on
frames of fewer than ``SMALL_JOB_FEATURES`` features, a ``device=``
call, a tensor and a prepared container stay where they are;
``device=`` with ``mesh=`` raises; the cluster, implied and
collect_cards apps take the default.

The cross-shard check: on a mesh of the CPU devices ``cpu:0`` ..
``cpu:3`` (tensors created there all lie on the CPU), a dispatch mode
tags every tensor with the shard it was created on or moved to and
records any op whose inputs carry two shards' tags, which on cards
would mix two devices in one op. Moves (``.to``, ``copy_``) are allowed,
as they are between cards; the collectives of ``FrameMesh`` and
``host_fetch`` move every part to the lead device first. The k-centers
loops, the sharded assignment, the PAM sweeps and the sharded analysis
paths must record none.
"""

import contextlib
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from enspara_tpu.cluster import engine as jengine
from enspara_tpu.cluster import engine_kmedoids as jek
from enspara_tpu.cluster import hybrid_device as jax_hybrid_device
from enspara_tpu.cluster import kcenters as jax_kcenters
from enspara_tpu.msm import transition_matrices as jtm

from enspara_tpu_torch.apps import cluster as cluster_app
from enspara_tpu_torch.apps import collect_cards
from enspara_tpu_torch.apps import implied_timescales as its_app
from enspara_tpu_torch.apps import main as main_app
from enspara_tpu_torch.cards import cards_matrices
from enspara_tpu_torch.cluster import (KCenters, KHybrid, engine,
                                       engine_kmedoids, hybrid,
                                       hybrid_device, kcenters, kmedoids)
from enspara_tpu_torch.msm import (assigns_to_counts_sharded,
                                   implied_timescales_batched)
from enspara_tpu_torch.msm import transition_matrices as tm
from enspara_tpu_torch.parallel import FrameMesh
from enspara_tpu_torch.parallel import mesh as pmesh

from test_torch_apps import write_fixture
from test_torch_cards_apps import write_peptide
from test_torch_port import assert_rmsd_close, basin_data

N, A, K, SWEEPS, SEED = 504, 8, 12, 2, 5
SMALL_JOB_FEATURES_DEFAULT = 3e9
kmedoids_mod = importlib.import_module('enspara_tpu_torch.cluster.kmedoids')


@pytest.fixture(autouse=True)
def _cpu_platform(monkeypatch):
    """Host inputs run on the CPU in these tests: with no device named,
    the port sends them to the card. Torch runs on one thread: the
    tier-1 run puts several test workers on one host's cores."""
    monkeypatch.setenv('ENSPARA_TPU_PLATFORM', 'cpu')
    monkeypatch.setenv('ENSPARA_TPU_CACHE_DIR', '0')
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mesh4():
    return FrameMesh(['cpu'] * 4)


@pytest.fixture
def four_cards(monkeypatch):
    """The default mesh as on a machine with four visible cards, the
    small-job rule off; returns the shard counts the entry points
    prepared frames for, in order."""
    monkeypatch.setattr(pmesh, 'frame_mesh',
                        lambda n=None, devices=None: _mesh4())
    monkeypatch.setattr(collect_cards, 'frame_mesh',
                        lambda n=None, devices=None: _mesh4())
    monkeypatch.setattr(pmesh, 'SMALL_JOB_FEATURES', 0.0)
    return _spy_shards(monkeypatch)


def _spy_shards(monkeypatch):
    seen = []
    real = engine._prepared

    def spy(*a, **kw):
        prep = real(*a, **kw)
        seen.append(getattr(prep, 'n_shards', 1))
        return prep
    monkeypatch.setattr(engine, '_prepared', spy)
    return seen


def _jax_bits(seed, n_sweeps, n, device):
    """The JAX sweep's bits: ``jax.random.bits(fold_in(PRNGKey(seed),
    s), (n,))``, n a multiple of 8 so that the JAX layout pads none."""
    key = jax.random.PRNGKey(seed)
    for s in range(n_sweeps):
        yield torch.from_numpy(np.asarray(jax.random.bits(
            jax.random.fold_in(key, s), (n,), jnp.uint32)).astype(
                np.int64)).to(device)


@functools.lru_cache(maxsize=None)
def frames():
    return basin_data(np.random.default_rng(3), N, A, n_basins=30)


@functools.lru_cache(maxsize=None)
def features():
    rng = np.random.RandomState(4)
    X = (rng.normal(size=(30, 8)) * 4.0)[rng.randint(0, 30, N)]
    return (X + rng.normal(size=(N, 8))).astype(np.float32)


def _gsum(X):
    Xc = X - X.mean(axis=1, keepdims=True)
    return 2 * float((Xc ** 2).sum((1, 2)).max())


def _seed():
    """A k-centers warm start of the frames, from the JAX package."""
    r = jax_kcenters(frames(), 'rmsd', n_clusters=K)
    return (np.asarray(r.assignments), np.asarray(r.distances),
            np.asarray(r.center_indices))


def _kc(r):
    return (np.asarray(r.center_indices), np.asarray(r.assignments),
            np.asarray(r.distances))


def _mad(r):
    """The sweeps' ``(medoids, distances, assignments)`` as
    ``(medoids, assignments, distances)``."""
    return r[0], r[2], r[1]


def _labels():
    a = np.asarray(jax_kcenters(frames(), 'rmsd', n_clusters=K)
                   .assignments).reshape(6, -1)
    return a, np.ones_like(a, bool)


# entry: (port call, JAX call, kind of result); each call takes the
# placement keywords
ENTRIES = {
    'kcenters_rmsd': (
        lambda **kw: _kc(kcenters(frames(), 'rmsd', n_clusters=K, **kw)),
        lambda: _kc(jax_kcenters(frames(), 'rmsd', n_clusters=K)), 'rmsd'),
    'kcenters_euclidean': (
        lambda **kw: _kc(kcenters(features(), 'euclidean', n_clusters=K,
                                  **kw)),
        lambda: _kc(jax_kcenters(features(), 'euclidean', n_clusters=K)),
        'features'),
    'assign_device': (
        lambda **kw: engine.assign_device(
            frames(), frames()[_seed()[2]], 'rmsd', **kw),
        lambda: jengine.assign_device(
            frames(), frames()[_seed()[2]], 'rmsd'), 'rmsd'),
    'hybrid_device': (
        lambda **kw: _kc(hybrid_device(frames(), 'rmsd', n_iters=SWEEPS,
                                       n_clusters=K, seed=SEED, **kw)),
        lambda: _kc(jax_hybrid_device(frames(), 'rmsd', n_iters=SWEEPS,
                                      n_clusters=K, seed=SEED)), 'rmsd'),
    'kmedoids_sweeps_device': (
        lambda **kw: _mad(engine_kmedoids.kmedoids_sweeps_device(
            frames(), 'rmsd', *_seed(), n_sweeps=SWEEPS, seed=SEED, **kw)),
        lambda: _mad(jek.kmedoids_sweeps_device(
            frames(), 'rmsd', *_seed(), n_sweeps=SWEEPS, seed=SEED)),
        'rmsd'),
    'assigns_to_counts_sharded': (
        lambda **kw: (assigns_to_counts_sharded(*_labels(), 3, K, **kw)
                      .numpy(),),
        lambda: (np.asarray(jtm.assigns_to_counts_sharded(
            *_labels(), 3, K)),), 'counts'),
}


@pytest.mark.parametrize('entry', list(ENTRIES))
def test_default_mesh_equals_explicit_mesh_and_jax(entry, four_cards,
                                                   monkeypatch):
    """mesh=None runs over the (patched) 4-shard default: bit for bit
    the explicit mesh, and the JAX package's mesh=None over 8 devices at
    the parity bars."""
    monkeypatch.setattr(engine_kmedoids, 'sweep_bits', _jax_bits)
    port, jax_call, kind = ENTRIES[entry]
    counted = []
    real = tm.assigns_to_counts_device
    monkeypatch.setattr(tm, 'assigns_to_counts_device', lambda *a, **kw: (
        counted.append(1), real(*a, **kw))[1])
    got = port()
    shards, counted[:] = list(four_cards), []
    ref = port(mesh=_mesh4())
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    if kind == 'counts':
        assert len(counted) == 4
    else:
        assert shards and set(shards) == {4}, shards
    want = jax_call()
    for g, w in zip(got[:-1], want[:-1]):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    if kind == 'counts':
        np.testing.assert_array_equal(got[0], want[0])
    elif kind == 'features':
        np.testing.assert_allclose(got[-1], want[-1], rtol=1e-5, atol=1e-6)
    else:
        assert_rmsd_close(got[-1], want[-1], _gsum(frames()), A)
    if entry in ('hybrid_device', 'kmedoids_sweeps_device'):
        assert not np.array_equal(got[0], _seed()[2]), 'no swap accepted'


def test_small_job_rule(monkeypatch):
    """Frames of fewer than SMALL_JOB_FEATURES features (n * features of
    a frame) take one device of the default platform at the k-centers,
    assignment, k-hybrid and PAM-sweep entry points, never a CPU detour
    from a card; at or above it, the default mesh; 0 turns the rule
    off."""
    monkeypatch.setattr(pmesh, 'frame_mesh',
                        lambda n=None, devices=None: _mesh4())
    seen = _spy_shards(monkeypatch)
    assert pmesh.SMALL_JOB_FEATURES == SMALL_JOB_FEATURES_DEFAULT
    features = pmesh.job_features(frames())
    assert features == N * A * 3 < pmesh.SMALL_JOB_FEATURES
    assert pmesh.small_job_device(features) == torch.device('cpu')
    assert pmesh.small_job_device(pmesh.SMALL_JOB_FEATURES) is None
    assert pmesh.resolve_placement(frames(), small_job_rule=True) == (
        torch.device('cpu'), None)
    assert pmesh.resolve_placement(frames())[1].size == 4
    small = kcenters(frames(), 'rmsd', n_clusters=K)
    engine.assign_device(frames(), frames()[:K], 'rmsd')
    hybrid_device(frames(), 'rmsd', n_iters=1, n_clusters=K, seed=1)
    engine_kmedoids.kmedoids_sweeps_device(
        frames(), 'rmsd', small.assignments, small.distances,
        small.center_indices, n_sweeps=1)
    assert seen == [1] * 5, seen
    monkeypatch.setattr(pmesh, 'SMALL_JOB_FEATURES', features)
    assert pmesh.resolve_placement(frames(), small_job_rule=True)[1].size \
        == 4
    monkeypatch.setattr(pmesh, 'SMALL_JOB_FEATURES', 0.0)
    assert pmesh.small_job_device(features) is None
    del seen[:]
    big = kcenters(frames(), 'rmsd', n_clusters=K)
    engine_kmedoids.kmedoids_sweeps_device(
        frames(), 'rmsd', small.assignments, small.distances,
        small.center_indices, n_sweeps=1)
    assert seen == [4, 4]
    for a, b in zip(_kc(small), _kc(big)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('how', ['device', 'tensor', 'container'])
def test_one_device_inputs_stay(how, four_cards):
    """A device= call, a tensor and a prepared container run where they
    are, whatever the default mesh; a sharded container runs over its
    own shards."""
    X = frames()
    a, d, m = _seed()
    if how == 'device':
        kw, inp = {'device': 'cpu'}, X
    elif how == 'tensor':
        kw, inp = {}, torch.from_numpy(X)
    else:
        kw, inp = {}, engine.prepare_rmsd_frames(X, mesh=FrameMesh(
            ['cpu'] * 2))
    res = engine.kcenters_device(inp, 'rmsd', n_clusters=K, **kw)
    got_a = engine.assign_device(inp, X[m], 'rmsd', **kw)
    got_s = engine_kmedoids.kmedoids_sweeps_device(inp, 'rmsd', a, d, m,
                                                   n_sweeps=1, seed=2, **kw)
    want = 2 if how == 'container' else 1
    assert list(four_cards) == [want] * 3, four_cards
    ref = engine.kcenters_device(X, 'rmsd', n_clusters=K, device='cpu')
    np.testing.assert_array_equal(res.center_indices, ref.center_indices)
    np.testing.assert_array_equal(res.assignments, ref.assignments)
    ref_a = engine.assign_device(X, X[m], 'rmsd', device='cpu')
    np.testing.assert_array_equal(got_a[0], ref_a[0])
    ref_s = engine_kmedoids.kmedoids_sweeps_device(
        X, 'rmsd', a, d, m, n_sweeps=1, seed=2, device='cpu')
    np.testing.assert_array_equal(got_s[0], ref_s[0])
    np.testing.assert_array_equal(got_s[2], ref_s[2])


def test_device_with_mesh_raises():
    """Every entry point that resolves the default refuses device= with
    mesh=, as placement() does."""
    X, mesh = frames(), _mesh4()
    a, d, m = _seed()
    calls = [
        lambda **kw: kcenters(X, 'rmsd', n_clusters=3, **kw),
        lambda **kw: KCenters('rmsd', n_clusters=3, **kw).fit(X),
        lambda **kw: engine.kcenters_device(features(), 'euclidean',
                                            n_clusters=3, **kw),
        lambda **kw: engine.assign_device(X, X[:3], 'rmsd', **kw),
        lambda **kw: engine.prepare_sharded(features(), 'euclidean', **kw),
        lambda **kw: hybrid_device(X, 'rmsd', n_clusters=3, **kw),
        lambda **kw: hybrid(X, 'rmsd', n_clusters=3, **kw),
        lambda **kw: KHybrid('rmsd', n_clusters=3, **kw).fit(X),
        lambda **kw: kmedoids(X, 'rmsd', n_clusters=3, **kw),
        lambda **kw: engine_kmedoids.kmedoids_sweeps_device(
            X, 'rmsd', a, d, m, **kw),
        lambda **kw: its_app.run(_labels()[0], its_app.process_command_line(
            ['implied', '--assignments', 'in-memory', '--lag-times',
             '1:4:1']), **kw),
        lambda **kw: cards_matrices([np.zeros((9, 2), int)],
                                    np.full(2, 3), **kw),
    ]
    for call in calls:
        with pytest.raises(ValueError, match='not both'):
            call(device='cpu', mesh=mesh)


def test_apps_take_the_default_mesh(tmp_path, four_cards, monkeypatch):
    """The cluster CLI (one process), the implied CLI's batched solve and
    collect_cards run over the default mesh, their outputs equal to one
    device's (collect_cards also to the JAX app over its 8 devices)."""
    pdb, trjs, _ = write_fixture(tmp_path)
    out = {}
    for tag in ('mesh', 'one'):
        if tag == 'one':
            monkeypatch.setattr(pmesh, 'frame_mesh',
                                lambda n=None, devices=None: FrameMesh(
                                    ['cpu']))
        argv = ['cluster', '--trajectories', *trjs, '--topology', pdb,
                '--atoms', 'name CA', '--algorithm', 'kcenters',
                '--cluster-number', '7', '--subsample', '2',
                '--distances', str(tmp_path / ('%s_d.h5' % tag)),
                '--assignments', str(tmp_path / ('%s_a.h5' % tag)),
                '--center-features', str(tmp_path / ('%s_c.pkl' % tag)),
                '--center-indices', str(tmp_path / ('%s_i.npy' % tag))]
        assert cluster_app.main(argv) == 0
        out[tag] = np.load(tmp_path / ('%s_i.npy' % tag))
    # k-centers, then the --subsample reassignment: on 4 shards, then on
    # the one-card machine's default
    assert four_cards == [4, 4, 1, 1], four_cards
    np.testing.assert_array_equal(out['mesh'], out['one'])

    monkeypatch.setattr(pmesh, 'frame_mesh',
                        lambda n=None, devices=None: _mesh4())
    monkeypatch.setattr(its_app, '_batched_device', lambda device: True)
    meshes = []
    real = its_app.implied_timescales_batched
    monkeypatch.setattr(its_app, 'implied_timescales_batched',
                        lambda *a, **kw: (meshes.append(kw['mesh']),
                                          real(*a, **kw))[1])
    args = its_app.process_command_line(
        ['implied', '--assignments', 'in-memory', '--lag-times', '1:9:2',
         '--n-eigenvalues', '3'])
    ts = its_app.run(_labels()[0], args)
    ts1 = its_app.run(_labels()[0], args, device='cpu')
    assert meshes[0].size == 4 and meshes[1] is None
    np.testing.assert_array_equal(ts, ts1)

    pep, files = write_peptide(tmp_path)
    seen = []
    real_cards = collect_cards.cards
    monkeypatch.setattr(collect_cards, 'cards', lambda *a, **kw: (
        seen.append(kw['mesh']), real_cards(*a, **kw))[1])
    mats = {}
    for tag in ('mesh', 'one'):
        if tag == 'one':
            monkeypatch.setattr(collect_cards, 'frame_mesh',
                                lambda n=None, devices=None: FrameMesh(
                                    ['cpu']))
        pkl = str(tmp_path / ('%s.pkl' % tag))
        assert main_app.main(['enspara', 'cards', '--trajectories', *files,
                              '--topology', pep, '--matrices', pkl,
                              '--indices', str(tmp_path / 'i.csv'),
                              '--buffer-size', '20']) == 0
        mats[tag] = np.load(pkl, allow_pickle=True)
    assert seen[0].size == 4 and seen[1] is None
    for k in mats['one']:
        np.testing.assert_array_equal(mats['mesh'][k], mats['one'][k])


# ---------------------------------------------------------------------
# the cross-shard check
# ---------------------------------------------------------------------

_BASE_DEVICE = torch._C.TensorBase.device


def _index(device):
    """The shard a CPU device names (``cpu:k``), else None."""
    if device is None:
        return None
    device = torch.device(device)
    return device.index if device.type == 'cpu' else None


class ShardTags(TorchDispatchMode):
    """Tags each op's tensor outputs with the shard of its inputs, or of
    the ``cpu:k`` device it names, and records the ops whose inputs
    carry two shards' tags. ``_to_copy`` and ``copy_`` are moves."""

    def __init__(self):
        super().__init__()
        self.mixed = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        if name == '_to_copy':
            tag = _index(kwargs['device']) if 'device' in kwargs \
                else getattr(args[0], '_shard', None)
        elif name == 'copy_':
            tag = getattr(args[0], '_shard', None)
        else:
            tags = {getattr(t, '_shard', None) for t in tree_flatten(
                (args, kwargs))[0] if isinstance(t, torch.Tensor)} - {None}
            if len(tags) > 1:
                self.mixed.append((str(func), sorted(tags)))
            tag = _index(kwargs.get('device'))
            if tag is None and len(tags) == 1:
                tag = tags.pop()
        if tag is not None:
            for t in tree_flatten(out)[0]:
                if isinstance(t, torch.Tensor):
                    t._shard = tag
        return out


@contextlib.contextmanager
def shard_tags():
    """The dispatch mode, with a tagged tensor's ``.device`` reading
    ``cpu:k`` (so that what the code places "on the shard's device"
    lands on that shard) and ``torch.as_tensor(..., device=cpu:k)``
    moving its result there."""
    as_tensor = torch.as_tensor

    def device(self):
        base = _BASE_DEVICE.__get__(self)
        tag = getattr(self, '_shard', None)
        return torch.device('cpu', tag) if tag is not None else base

    def tagged_as_tensor(data, dtype=None, device=None):
        k = _index(device)
        if k is None:
            return as_tensor(data, dtype=dtype, device=device)
        return as_tensor(data, dtype=dtype, device='cpu').to(
            torch.device('cpu', k))

    mode = ShardTags()
    torch.Tensor.device = property(device)
    torch.as_tensor = tagged_as_tensor
    try:
        with mode:
            yield mode
    finally:
        del torch.Tensor.device
        torch.as_tensor = as_tensor


def _tagged_mesh():
    return FrameMesh([torch.device('cpu', k) for k in range(4)])


def _kcenters_paths(mesh):
    X, F = frames(), features()
    return [engine.kcenters_device_fused(X, n_clusters=K, mesh=mesh),
            engine.kcenters_device_fused(X, n_clusters=K, mesh=mesh,
                                         tri_skip=False),
            engine.kcenters_device(F, 'euclidean', n_clusters=K, mesh=mesh)]


def _assign_paths(mesh):
    X, F = frames(), features()
    m = _seed()[2]
    return [engine.assign_device(X, X[m], 'rmsd', mesh=mesh),
            engine.assign_device(F, F[m], 'manhattan', mesh=mesh)]


def _pam_paths(mesh):
    X, F = frames(), features()
    a, d, m = _seed()
    fa, fd = engine.assign_device(F, F[m], 'euclidean', device='cpu')
    return [engine_kmedoids.kmedoids_sweeps_device(
                X, 'rmsd', a, d, m, n_sweeps=SWEEPS, seed=SEED, mesh=mesh),
            engine_kmedoids.kmedoids_sweeps_device(
                F, 'euclidean', fa, fd, m, n_sweeps=1, seed=SEED,
                mesh=mesh),
            _kc(hybrid_device(X, 'rmsd', n_iters=1, n_clusters=K, seed=3,
                              mesh=mesh))]


def _analysis_paths(mesh):
    a, m = _labels()
    rot = [np.random.default_rng(s).integers(0, 3, size=(120, 5))
           for s in (1, 2)]
    return [(assigns_to_counts_sharded(a, m, 2, K, mesh=mesh).numpy(),),
            (implied_timescales_batched(a, [1, 2, 3], n_times=2,
                                        mesh=mesh),),
            cards_matrices(rot, np.full(5, 3), mesh=mesh)]


PATHS = {'kcenters': _kcenters_paths, 'assign': _assign_paths,
         'pam': _pam_paths, 'analysis': _analysis_paths}


@pytest.mark.parametrize('path', list(PATHS))
def test_no_shard_reads_another_shards_tensor(path):
    """On the tagged mesh no op mixes two shards' tensors, and every
    result equals the untagged 4-shard mesh's; the check itself flags
    an op that mixes two shards."""
    with shard_tags() as mode:
        got = PATHS[path](_tagged_mesh())
    assert mode.mixed == [], mode.mixed[:5]
    ref = PATHS[path](_mesh4())
    for g, r in zip(got, ref):
        for x, y in zip(g, r):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    with shard_tags() as mode:
        one = torch.zeros(3, device=torch.device('cpu', 1))
        two = torch.ones(3, device=torch.device('cpu', 2))
        (one + two.to(one.device)).sum()
        assert mode.mixed == []
        one + two
    assert len(mode.mixed) == 1
