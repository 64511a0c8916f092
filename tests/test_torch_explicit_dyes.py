"""The port's explicit-dye geometry (``geometry/explicit_r0_calc.py`` and
its readers ``geometry/_dye_files.py``) held against the JAX package's on
the CPU, on a synthetic dye library that ``chip_smoke.explicit_dye_library``
writes in a temporary directory (both packages read it through
``$ENSPARA_TPU_DYE_DIR``): the YAML and CSV readers against pyyaml and
pandas, (J, QD, Td), the Kabsch placement, the kept dye states of the clash
test, ``map_dye_on_protein``, the bursts and the dyeless-state pruning; and
the ``enspara_tpu_torch.util`` re-exports.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch
import yaml

import enspara_tpu.util as jax_util
from enspara_tpu import io as jax_io
from enspara_tpu.geometry import explicit_r0_calc as jax_r0c
from enspara_tpu.io import Topology as JaxTopology
from enspara_tpu.io import Trajectory as JaxTrajectory

import enspara_tpu_torch.util as util
from enspara_tpu_torch import io as port_io
from enspara_tpu_torch.exception import DataInvalid
from enspara_tpu_torch.geometry import _dye_files
from enspara_tpu_torch.geometry import explicit_r0_calc as r0c
from enspara_tpu_torch.io import Topology, Trajectory

from chip_smoke import (explicit_dye_library, globule, globule_frames,
                        label_sites, lys_topology)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILTIN = os.path.join(ROOT, 'enspara_tpu_torch', 'data', 'dyes_builtin')
N_RES, N_DYE, N_CENTERS = 30, 40, 4


@pytest.fixture(scope='module')
def library(tmp_path_factory):
    path = str(tmp_path_factory.mktemp('dyes'))
    return path, explicit_dye_library(path, 0, n_frames=N_DYE)


@pytest.fixture(autouse=True)
def _cpu_platform(monkeypatch, library):
    """Host inputs run on the CPU in these tests: with no device named,
    the port sends them to the card. Both packages read the synthetic
    library. Torch runs on one thread: the tier-1 run puts several test
    workers on one host's cores."""
    monkeypatch.setenv('ENSPARA_TPU_PLATFORM', 'cpu')
    monkeypatch.setenv('ENSPARA_TPU_DYE_DIR', library[0])
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def proteins():
    """(port, JAX) trajectories of globule frames and two label pairs."""
    xyz, _, groups = globule_frames(globule(N_RES, seed=8), N_CENTERS,
                                    seed=9, planted=(1, 2, 0.4))
    port = Trajectory(xyz, lys_topology(Topology, N_RES))
    jax = JaxTrajectory(xyz, lys_topology(JaxTopology, N_RES))
    return port, jax, label_sites(port, 2, np.concatenate(groups))


def dyes(library):
    """[(name, port trajectory, JAX trajectory)] of the two dyes."""
    return [(name, port_io.load(dcd, top=pdb), jax_io.load(dcd, top=pdb))
            for name, dcd, pdb, _ in library[1].values()]


def test_util_reexports_the_timing_helpers():
    names = ('timed', 'trace_region', 'device_memory_stats',
             'setup_logging')
    for mod in (util, jax_util):
        for name in names:
            assert callable(getattr(mod, name)), (mod.__name__, name)
    from enspara_tpu_torch.util import log
    assert all(getattr(util, n) is getattr(log, n) for n in names)


def test_modules_load_without_yaml_and_pandas(library):
    code = (
        "import sys\n"
        "sys.modules['yaml'] = None\n"
        "sys.modules['pandas'] = None\n"
        "from enspara_tpu_torch.geometry import explicit_r0_calc, "
        "dye_lifetimes\n"
        "from enspara_tpu_torch.apps import smFRET_dye_MC\n"
        "lib = explicit_r0_calc.load_library()\n"
        "J, QD, Td = explicit_r0_calc.get_dye_overlap(*sorted(lib))\n"
        "assert J > 0 and QD.shape == Td.shape == (1,)\n"
        "assert 'yaml' not in [m.split('.')[0] for m in sys.modules "
        "if sys.modules[m] is not None]\n"
        "print('ok')\n")
    env = dict(os.environ, ENSPARA_TPU_DYE_DIR=library[0],
               ENSPARA_TPU_PLATFORM='cpu',
               PYTHONPATH=ROOT + os.pathsep + os.environ.get('PYTHONPATH',
                                                             ''))
    out = subprocess.run([sys.executable, '-c', code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == 'ok', out.stderr


def test_yaml_reader_equals_pyyaml(library, tmp_path):
    for path in (os.path.join(BUILTIN, 'libraries.yml'),
                 os.path.join(library[0], 'libraries.yml')):
        with open(path) as f:
            assert _dye_files.load_library_yaml(path) == yaml.safe_load(f)
    text = ("---\n# a comment\nSome Dye 1 X:\n    author: 'it''s me'  # c\n"
            "    citation: \"J. Chem. Phys.\"\n    filename: SD1_cutoff10\n"
            "    mu:\n      - C7 and resname T39\n      - C10\n"
            "    negative: [ ]\n    r:\n    - C3\n")
    path = tmp_path / 'lib.yml'
    path.write_text(text)
    assert _dye_files.load_library_yaml(str(path)) == yaml.safe_load(text)


def test_yaml_reader_refuses_what_it_does_not_know(tmp_path):
    cases = {
        'a number': 'D 1:\n  filename: 488\n',
        'a boolean': 'D 1:\n  positive: yes\n',
        'a null': 'D 1:\n  mu:\n  r:\n  - C\n',
        'a flow map': 'D 1:\n  mu: {a: C}\n',
        'a nested map': 'D 1:\n  mu:\n    x: C\n',
        'a top-level scalar': 'D 1: C\n',
        'a block scalar': 'D 1:\n  citation: |\n    text\n',
        'a duplicate key': 'D 1:\n  r:\n  - C\n  r:\n  - N\n',
        'an anchor': 'D 1:\n  r: &x C\n',
        'a tab': 'D 1:\n\tr: C\n',
    }
    for what, text in cases.items():
        path = tmp_path / 'bad.yml'
        path.write_text(text)
        with pytest.raises(DataInvalid, match=r'line [0-9]+: '):
            _dye_files.load_library_yaml(str(path))


def test_csv_reader_equals_pandas(tmp_path):
    names = ['Type', 'Chromophore', 'Ext_coeff', 'QD', 'Td']
    (tmp_path / 'holes.csv').write_text(
        'Wavelength,Excitation,Emission,Label\n300,0.5,,a\n301,,2,\n'
        '302,1e-3,3,488D\n\n303,2,4,b\n304\n')
    (tmp_path / 'noheader.csv').write_text(
        'Alexa,488,71000,0.92,4.1\nAlexa,594C,90000.5,0.66,3.9\n')
    cases = [(os.path.join(BUILTIN, 'R0', f), None)
             for f in ('SimFluor488D.csv', 'SimFluor594A.csv')]
    cases += [(os.path.join(BUILTIN, 'R0', 'Dyes_extinction_QD.csv'), names),
              (str(tmp_path / 'holes.csv'), None),
              (str(tmp_path / 'noheader.csv'), names)]
    for path, cols in cases:
        ours = _dye_files.read_csv(path, names=cols)
        ref = pd.read_csv(path, names=cols) if cols else pd.read_csv(path)
        assert list(ours) == list(ref.columns), path
        for c in ref.columns:
            want = ref[c].to_numpy()
            if want.dtype == object:
                assert ours[c].dtype == object
                assert all((a == b) or (a != a and b != b)
                           for a, b in zip(ours[c], want)), (path, c)
            else:
                assert ours[c].dtype == want.dtype, (path, c)
                np.testing.assert_array_equal(ours[c], want)
    (tmp_path / 'long.csv').write_text('a,b\n1,2,3\n')
    with pytest.raises(DataInvalid):
        _dye_files.read_csv(str(tmp_path / 'long.csv'))


def test_dye_overlap_equals_jax(library):
    names = [v[0] for v in library[1].values()]
    for pair in (names, names[::-1], names[:1] * 2):
        ours, ref = r0c.get_dye_overlap(*pair), jax_r0c.get_dye_overlap(*pair)
        assert ours[0] == ref[0]
        for a, b in zip(ours[1:], ref[1:]):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype


@pytest.mark.parametrize('acceptor_rows', [400, 600])
def test_dye_overlap_of_unequal_spectra(monkeypatch, tmp_path, acceptor_rows):
    """pandas pairs the rows by position: a shorter acceptor spectrum gives
    NaN past its end (J = NaN), a longer one cannot be integrated."""
    shutil.copytree(os.path.join(BUILTIN, 'R0'), tmp_path / 'R0')
    src = tmp_path / 'R0' / 'SimFluor594A.csv'
    lines = src.read_text().splitlines()
    body = lines[1:]
    body = (body + [l.replace(l.split(',')[0], str(800 + i), 1)
                    for i, l in enumerate(body)])[:acceptor_rows]
    src.write_text('\n'.join([lines[0]] + body) + '\n')
    monkeypatch.setenv('ENSPARA_TPU_DYE_DIR', str(tmp_path))
    pair = ('SimFluor 488D C1R', 'SimFluor 594A C1R')
    try:
        ref = jax_r0c.get_dye_overlap(*pair)
    except ValueError:
        with pytest.raises(ValueError):
            r0c.get_dye_overlap(*pair)
        assert acceptor_rows > 501
        return
    ours = r0c.get_dye_overlap(*pair)
    assert acceptor_rows < 501 and np.isnan(ref[0]) and np.isnan(ours[0])
    for a, b in zip(ours[1:], ref[1:]):
        np.testing.assert_array_equal(a, b)


def test_kabsch_placement_equals_jax(library):
    port, jax, pairs = proteins()
    lib, jlib = r0c.load_library(), jax_r0c.load_library()
    assert lib == jlib
    for name, pd_, jd in dyes(library):
        np.testing.assert_array_equal(pd_.xyz, jd.xyz)
        for res in pairs.ravel():
            for c in range(N_CENTERS):
                ours = r0c.align_full_dye_to_res(port[c], pd_, int(res),
                                                 name, lib)
                ref = jax_r0c.align_full_dye_to_res(jax[c], jd, int(res),
                                                    name, jlib)
                assert ours.dtype == np.float32
                assert np.abs(ours - ref).max() <= 1e-6
                np.testing.assert_array_equal(ours, ref)


def test_kept_dye_states_equal_jax(library):
    port, jax, pairs = proteins()
    lib = r0c.load_library()
    kept = []
    for name, pd_, jd in dyes(library):
        for res in pairs.ravel():
            for c in range(N_CENTERS):
                placed, jplaced = pd_.copy(), jd.copy()
                placed.xyz = r0c.align_full_dye_to_res(port[c], pd_,
                                                       int(res), name, lib)
                jplaced.xyz = placed.xyz
                ours = r0c.remove_touches_protein_dye_traj(
                    port[c], placed, int(res))
                ref = jax_r0c.remove_touches_protein_dye_traj(
                    jax[c], jplaced, int(res))
                np.testing.assert_array_equal(ours, ref)
                kept.append(len(ours))
            # every center at once, as the CLI runs it
            _, all_kept, _ = r0c._place_and_prune(port, pd_, int(res), name,
                                                  lib, n_procs=2)
            for c, k in enumerate(all_kept):
                placed = pd_.copy()
                placed.xyz = r0c.align_full_dye_to_res(port[c], pd_,
                                                       int(res), name, lib)
                np.testing.assert_array_equal(
                    k, jax_r0c.remove_touches_protein_dye_traj(
                        jax[c], placed, int(res)))
    # the synthetic dyes neither all clash nor all fit
    assert 0 < min(kept) and max(kept) < N_DYE


def test_clash_test_decides_near_ties_as_cdist(monkeypatch):
    """Dye atoms planted at their clearance to the last bit take the exact
    re-test, and the counts equal scipy's strict ``>`` on float64."""
    import scipy.spatial.distance
    rng = np.random.default_rng(3)
    prot = rng.normal(0, 1.0, (1, 60, 3)).astype(np.float32)
    j = rng.permutation(60)[:30]
    dirs = rng.normal(size=(30, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    pts = (prot[0, j] + 0.2 * dirs).astype(np.float32)
    d = np.sqrt(((pts.astype(np.float64)
                  - prot[0, j].astype(np.float64)) ** 2).sum(1))
    clearance = np.full(60, 0.01)
    # on the clearance (a clash) or one ulp inside it (clear)
    clearance[j] = np.where(np.arange(30) % 2, d, np.nextafter(d, 0))
    dye = np.concatenate([pts, rng.normal(0, 1.0, (30, 3)).astype(
        np.float32)]).reshape(1, 6, 10, 3)
    ref = (scipy.spatial.distance.cdist(
        dye.reshape(-1, 3).astype(np.float64),
        prot[0].astype(np.float64)) > clearance).all(1).reshape(6, 10).sum(1)
    calls = []
    cdist = r0c.dyefs._cdist
    monkeypatch.setattr(r0c.dyefs, '_cdist',
                        lambda a, b: calls.append(len(a)) or cdist(a, b))
    np.testing.assert_array_equal(
        r0c._clear_atoms(dye, prot, clearance, torch.device('cpu'))[0], ref)
    assert sum(calls) >= 30
    monkeypatch.setattr(r0c.dyefs, '_CHUNK_ELEMS', 64)   # one row a block
    np.testing.assert_array_equal(
        r0c._clear_atoms(dye, prot, clearance, torch.device('cpu'))[0], ref)


def test_map_dye_on_protein_equals_jax(library, tmp_path):
    port, jax, pairs = proteins()
    name = next(iter(library[1].values()))[0]
    res = int(pairs[0, 0])
    ours = r0c.map_dye_on_protein(port, name, res, outpath=str(tmp_path),
                                  save_aligned_dyes=True, n_procs=2)
    ref = jax_r0c.map_dye_on_protein(jax, name, res, n_procs=2)
    assert len(ours) == len(ref) == N_CENTERS
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)
    saved = sorted(os.listdir(tmp_path / 'dye-alignments'))
    assert saved and all(f.endswith('-residue%d.dcd' % res) for f in saved)


def test_bursts_and_pruning_equal_jax(library):
    port, jax, pairs = proteins()
    names = [v[0] for v in library[1].values()]
    coords = [r0c.map_dye_on_protein(port, n, int(r))
              for n, r in zip(names, pairs[0])]
    jcoords = [jax_r0c.map_dye_on_protein(jax, n, int(r))
               for n, r in zip(names, pairs[0])]
    rng = np.random.default_rng(5)
    C = rng.integers(0, 20, (N_CENTERS, N_CENTERS))
    C = C + C.T + 5 * np.eye(N_CENTERS, dtype=int)
    coords[0] = list(coords[0])
    coords[0][1] = np.zeros((0, 9))
    jcoords[0] = list(jcoords[0])
    jcoords[0][1] = np.zeros((0, 9))
    eqs0 = C.sum(1) / C.sum()
    ours = r0c.remove_dyeless_msm_states(coords[0], list(coords[1]),
                                         *names, eqs0, C)
    ref = jax_r0c.remove_dyeless_msm_states(jcoords[0], list(jcoords[1]),
                                            *names, eqs0, C)
    np.testing.assert_array_equal(ours[1], ref[1])
    np.testing.assert_allclose(ours[0], ref[0], rtol=1e-12, atol=1e-15)
    assert ours[0][1] == 0
    frames = [np.cumsum(rng.integers(1, 5, k)) for k in (7, 12, 3)]
    T, pops = ours[1], ours[0]
    a = r0c.simulate_burst_k2(frames, T, pops, ours[2], ours[3], *names,
                              random_state=11)
    b = jax_r0c.simulate_burst_k2(frames, T, pops, ref[2], ref[3], *names,
                                  random_state=11)
    for x, y in zip(a, b):
        for u, v in zip(x, y):
            np.testing.assert_array_equal(u, v)
    k2, r = r0c.sample_dye_coords(ours[2], ours[3], [0, 2, 3],
                                  rng=np.random.default_rng(2))
    jk2, jr = jax_r0c.sample_dye_coords(ref[2], ref[3], [0, 2, 3],
                                        rng=np.random.default_rng(2))
    np.testing.assert_array_equal(k2, jk2)
    np.testing.assert_array_equal(r, jr)
