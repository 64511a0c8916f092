"""The port's CARDS chain (``enspara_tpu_torch.cards``) held against the
JAX package's on the same numpy inputs, on the CPU: transitions (1-D,
2-D, ragged), disorder labels exactly (the host painter and the device
painter), the four CARDS matrices within 1e-12 (on one device and on a
4-shard CPU mesh) and ``cards()`` of a small LYS peptide. Also the
reference names the port's ported info-theory, CARDS and rotamer
modules export (``tests/test_api_surface_parity.py :: SURFACE``).
"""

import importlib

import numpy as np
import pytest
import torch

from enspara_tpu import cards as jax_cards
from enspara_tpu import ra as jax_ra
from enspara_tpu.cards import disorder as jax_disorder

from enspara_tpu_torch import cards, ra
from enspara_tpu_torch.cards import disorder
from enspara_tpu_torch.parallel import FrameMesh

from test_api_surface_parity import SURFACE
from test_torch_rotamer import peptide

cards_mod = importlib.import_module('enspara_tpu_torch.cards.cards')


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


def rotamer_trajs(seed, lengths, F=8):
    """Rotamer-like int16 trajectories: dwells of mixed scales, one
    constant feature and one with a single step."""
    rng = np.random.RandomState(seed)
    out = []
    for T in lengths:
        p = rng.uniform(0.01, 0.2, F)
        step = rng.random_sample((T, F)) < p
        X = (np.cumsum(step * rng.randint(1, 3, (T, F)), axis=0) % 3)
        X[:, 0] = 2
        X[:, 1] = 0
        X[T // 2:, 1] = 1
        out.append(X.astype(np.int16))
    return out


@pytest.mark.parametrize('shape', ['1d', '2d', 'ragged'])
def test_transitions_match_jax(shape):
    rng = np.random.default_rng(1)
    a = (np.cumsum(rng.random((3, 60)) < 0.2, axis=1) % 3).astype(np.int16)
    if shape == '1d':
        got, want = disorder.transitions(a[0]), jax_disorder.transitions(a[0])
        np.testing.assert_array_equal(got, want)
        return
    if shape == '2d':
        x, jx = a, a
    else:
        lengths = [60, 17, 41]
        x = ra.RaggedArray(np.concatenate([a[i, :n] for i, n in
                                           enumerate(lengths)]),
                           lengths=lengths)
        jx = jax_ra.RaggedArray(x._data, lengths=lengths)
    got, want = disorder.transitions(x), jax_disorder.transitions(jx)
    assert isinstance(got, ra.RaggedArray)
    np.testing.assert_array_equal(got.lengths, want.lengths)
    np.testing.assert_array_equal(got._data, want._data)


def test_transition_stats_and_times_match_jax():
    trajs = rotamer_trajs(2, (400, 250))
    for x in (trajs[0], torch.from_numpy(trajs[0])):
        found = disorder._feature_transitions(x)
        for j in range(trajs[0].shape[1]):
            np.testing.assert_array_equal(
                found[j], jax_disorder.transitions(trajs[0][:, j]))
    tt, mo, md = disorder.transition_stats(trajs)
    jtt, jmo, jmd = jax_disorder.transition_stats(trajs)
    np.testing.assert_array_equal(mo, jmo)
    np.testing.assert_array_equal(md, jmd)
    for a, b in zip(tt, jtt):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    for t in (np.array([], int), np.array([10]), np.array([5, 10, 20])):
        assert disorder.traj_ord_disord_times(t) == \
            jax_disorder.traj_ord_disord_times(t)
    tt = np.array([2, 4, 30])
    np.testing.assert_array_equal(
        disorder.create_disorder_traj(tt, 40, 50., 3.),
        jax_disorder.create_disorder_traj(tt, 40, 50., 3.))


def test_disorder_labels_exact():
    """assign_order_disorder and the device painter of cards_matrices,
    with degenerate mean times (zero, equal, nan, inf ratios), equal to
    the JAX package's labels bit for bit."""
    trajs = rotamer_trajs(3, (500, 300, 120))
    labels, n = disorder.assign_order_disorder(trajs)
    jlabels, jn = jax_disorder.assign_order_disorder(trajs)
    np.testing.assert_array_equal(n, jn)
    for a, b in zip(labels, jlabels):
        assert a.dtype == b.dtype == np.int16
        np.testing.assert_array_equal(a, b)
    # transitions found on the host (arrays) and by torch (tensors)
    for x in (trajs, [torch.from_numpy(t) for t in trajs]):
        dev, _ = cards_mod._disorder_labels(x, torch.device('cpu'))
        for a, b in zip(dev, jlabels):
            assert a.dtype == torch.int8
            np.testing.assert_array_equal(a.numpy(), b)

    T, F = 400, 6
    tts = disorder._feature_transitions(trajs[0][:T, :F])
    ord_t = np.array([0.0, 3.0, np.nan, 10.0, 40.0, 2.0])
    dis_t = np.array([0.0, 3.0, 3.0, 0.0, 2.0, 40.0])
    seg = disorder._marked_segments(tts, ord_t, dis_t)
    jseg = jax_disorder._marked_segments(tts, ord_t, dis_t)
    for a, b in zip(seg, jseg):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(disorder._paint_labels(T, F, *seg),
                                  jax_disorder._paint_labels(T, F, *jseg))
    np.testing.assert_array_equal(
        cards_mod._paint_labels_device(T, F, *seg, device='cpu').numpy(),
        jax_disorder._paint_labels(T, F, *jseg))


@pytest.mark.parametrize('mesh', [None, 4])
def test_cards_matrices_match_jax(mesh):
    """Trajectories of unequal length, on one device and on a 4-shard CPU
    mesh (frames no multiple of 4)."""
    trajs = rotamer_trajs(4, (301, 97))
    n_states = np.full(8, 3, dtype='int16')
    got = cards.cards_matrices(
        trajs, n_states, mesh=None if mesh is None else FrameMesh(['cpu'] *
                                                                  mesh))
    want = jax_cards.cards_matrices(trajs, n_states)
    for g, w in zip(got, want):
        assert isinstance(g, np.ndarray) and g.dtype == np.float64
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-12)
    np.testing.assert_allclose(got[2], got[3].T, atol=1e-12)


def test_cards_of_a_lys_peptide_match_jax():
    """cards() from coordinates, a generator of two trajectories, against
    the JAX package's, within 1e-12."""
    port, jax_traj = peptide(n_res=5, n_frames=700, seed=7)
    got = cards.cards(t for t in (port, port[:400]))
    want = jax_cards.cards([jax_traj, jax_traj[:400]])
    np.testing.assert_array_equal(got[4], want[4])
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-12)
    assert np.abs(got[0] - np.diag(np.diag(got[0]))).max() > 1e-3


@pytest.mark.parametrize('ref_module', [
    'info_theory/mutual_info.py', 'info_theory/entropy.py',
    'cards/cards.py', 'cards/disorder.py', 'cards/featurizers.py',
    'geometry/rotamer.py'])
def test_port_exports_the_reference_names(ref_module):
    jax_module, names = SURFACE[ref_module]
    mod = importlib.import_module(jax_module.replace('enspara_tpu.',
                                                     'enspara_tpu_torch.'))
    missing = [n for n in names.split() if not hasattr(mod, n)]
    assert not missing, missing
