"""The port's MSM estimator layer held against the JAX package on the
same seeded assignments: ``calc_imp_times`` / ``implied_timescales``
(rtol 1e-10), ``MSM.fit`` (counts exactly equal, tprobs and eq_probs at
1e-12, mapping equal), ``MSM.load`` of a manifest the JAX package saved
(in a subprocess that imports neither the JAX package nor jax), and the
bootstrap (the same ``random_state`` resamples the same rows: replicates
equal to the JAX package's)."""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse
import torch

from enspara_tpu.msm import MSM as JaxMSM
from enspara_tpu.msm import MSMs as jax_MSMs
from enspara_tpu.msm import bootstrap as jax_bootstrap
from enspara_tpu.msm import builders as jax_builders
from enspara_tpu.msm import timescales as jax_timescales
from enspara_tpu.ra import RaggedArray as JaxRaggedArray

from enspara_tpu_torch.exception import DataInvalid
from enspara_tpu_torch.msm import MSM, MSMs, bootstrap, builders
from enspara_tpu_torch.msm import timescales
from enspara_tpu_torch.ra import RaggedArray

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _cpu_platform(monkeypatch):
    """Host inputs run on the CPU in these tests: with no device named,
    the port sends them to the card. Torch runs on one thread: the
    tier-1 run puts several test workers on one host's cores."""
    monkeypatch.setenv('ENSPARA_TPU_PLATFORM', 'cpu')
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _assigns(seed, dangling=False, n_states=6):
    """Four trajectories of a sticky random walk over ``n_states``
    states; with ``dangling`` the last frame of one trajectory is a state
    never left (ergodic trimming removes it)."""
    rng = np.random.default_rng(seed)
    a = np.empty((4, 400), np.int64)
    a[:, 0] = rng.integers(0, n_states, 4)
    for t in range(1, a.shape[1]):
        move = rng.random(4) < 0.3
        a[:, t] = np.where(move, rng.integers(0, n_states, 4), a[:, t - 1])
    if dangling:
        a[2, -1] = n_states
    return a


def _assert_msm_close(got, ref):
    """Counts exactly equal, tprobs and eq_probs at 1e-12, mapping
    equal."""
    gc = scipy.sparse.csr_matrix(got.tcounts_)
    rc = scipy.sparse.csr_matrix(ref.tcounts_)
    assert gc.shape == rc.shape and (gc != rc).nnz == 0
    np.testing.assert_allclose(
        scipy.sparse.csr_matrix(got.tprobs_).toarray(),
        scipy.sparse.csr_matrix(ref.tprobs_).toarray(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(np.asarray(got.eq_probs_),
                               np.asarray(ref.eq_probs_), rtol=0, atol=1e-12)
    assert got.mapping_.to_original == ref.mapping_.to_original


@pytest.mark.parametrize('trim', [False, True])
@pytest.mark.parametrize('builder', ['transpose', 'normalize', 'mle'])
def test_implied_timescales_match_jax(builder, trim):
    """Every lag, trimmed or not; the trimmed cases fan out over two
    threads (``n_procs``)."""
    a = _assigns(1, dangling=trim)
    n_procs = 2 if trim else None
    got = timescales.implied_timescales(a, [1, 2, 5], getattr(builders,
                                                              builder),
                                        n_times=3, trim=trim,
                                        n_procs=n_procs)
    ref = jax_timescales.implied_timescales(
        a, [1, 2, 5], getattr(jax_builders, builder), n_times=3, trim=trim,
        n_procs=n_procs)
    assert got.shape == (3, 3)
    np.testing.assert_allclose(got, ref, rtol=1e-10)
    one = timescales.calc_imp_times(a, 2, int(a.max()) + 1, 3,
                                    getattr(builders, builder), True, trim)
    np.testing.assert_allclose(one, ref[1], rtol=1e-10)


@pytest.mark.parametrize('builder', ['transpose', 'normalize', 'mle'])
def test_msm_fit_matches_jax(builder):
    a = _assigns(2, dangling=True)
    got = MSM(lag_time=3, method=builder, trim=True).fit(a)
    ref = JaxMSM(lag_time=3, method=builder, trim=True).fit(a)
    _assert_msm_close(got, ref)
    assert got.n_states_ == ref.n_states_ == 6
    assert got.method is getattr(builders, builder)


_LOAD_IN_A_CLEAN_PROCESS = '''
import sys
import numpy as np
from enspara_tpu_torch.convert import msm_from_manifest
from enspara_tpu_torch.msm import MSM, builders
path, assigns = sys.argv[1], np.load(sys.argv[2])
m = msm_from_manifest(path)
assert m.method is builders.transpose, m.method
assert m.config == MSM(lag_time=3, method='transpose', trim=True).config
# the JAX package's fit of the same assignments, read back
assert m == MSM(lag_time=3, method='transpose', trim=True).fit(assigns)
bad = [n for n in sys.modules if n == 'enspara_tpu'
       or n.startswith('enspara_tpu.') or n.split('.')[0] == 'jax']
assert not bad, bad
print('loaded', m.n_states_)
'''


@pytest.mark.parametrize('zipfile', [False, True])
def test_load_a_manifest_the_jax_package_saved(tmp_path, zipfile):
    a = _assigns(3, dangling=True)
    path = str(tmp_path / ('msm.zip' if zipfile else 'msm'))
    JaxMSM(lag_time=3, method='transpose', trim=True).fit(a).save(
        path, zipfile=zipfile)
    np.save(tmp_path / 'a.npy', a)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, '-c', _LOAD_IN_A_CLEAN_PROCESS, path,
         str(tmp_path / 'a.npy')], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ['loaded', '6']


def test_save_load_round_trip_and_foreign_globals(tmp_path):
    """The port's own manifest loads equal; a config that pickles any
    other global of the JAX package is refused."""
    m = MSM(lag_time=2, method=builders.mle, trim=True).fit(
        _assigns(4, dangling=True))
    m.save(str(tmp_path / 'own'))
    assert MSM.load(str(tmp_path / 'own')) == m

    class Foreign:
        def __reduce__(self):
            return (getattr, (JaxMSM, 'load'))
    m.save(str(tmp_path / 'foreign'))
    with open(tmp_path / 'foreign' / 'config.pkl', 'wb') as f:
        pickle.dump({**m.config, 'method': Foreign()}, f)
    with pytest.raises(DataInvalid, match='enspara_tpu.msm.msm'):
        MSM.load(str(tmp_path / 'foreign'))


def _ragged(seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 5, size=n) for n in (120, 80, 150, 60, 99)]


@pytest.mark.parametrize('case', ['fast', 'recount', 'chunk_by'])
def test_msms_match_jax(case):
    rows = _ragged(5)
    kw = dict(lag_time=2, method='transpose', n_trials=4, random_state=7,
              fast=case != 'recount')
    if case == 'chunk_by':
        kw['chunk_by'] = 50
    got = MSMs(RaggedArray(rows), **kw)
    ref = jax_MSMs(JaxRaggedArray(rows), **kw)
    assert len(got) == len(ref) == 4
    for g, r in zip(got, ref):
        _assert_msm_close(g, r)


def test_bootstrap_resamples_the_rows_of_the_jax_package():
    rows = _ragged(6)

    def row_lengths(data):
        return [len(r) for r in data]
    got = bootstrap(row_lengths, RaggedArray(rows), n_trials=5,
                    random_state=11, n_procs=2)
    ref = jax_bootstrap(row_lengths, JaxRaggedArray(rows), n_trials=5,
                        random_state=11)
    assert got == ref
    arr = np.arange(40).reshape(8, 5)
    assert all(np.array_equal(g, r) for g, r in zip(
        bootstrap(np.asarray, arr, 3, random_state=2),
        jax_bootstrap(np.asarray, arr, 3, random_state=2)))
