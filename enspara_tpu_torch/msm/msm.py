"""The MSM estimator object (counterpart of ``enspara_tpu/msm/msm.py:24-240``,
host code; reference: enspara/msm/msm.py:27).

A manifest saved by the JAX package loads here: its ``config.pkl``
pickles the builder by its module path (``enspara_tpu.msm.builders.<name>``),
which :meth:`MSM.load` maps to this package's builder of that name without
importing the JAX package.
"""

import json
import logging
import os
import pickle
import shutil
import tempfile

import numpy as np
from scipy import sparse
from scipy.io import mmwrite, mmread

from ..exception import DataInvalid, ImproperlyConfigured
from . import builders
from .transition_matrices import (assigns_to_counts, TrimMapping,
                                  trim_disconnected)

logger = logging.getLogger(__name__)

__all__ = ['MSM']

# the packages whose pickled builders map to this package's builders
_FOREIGN_BUILDERS = ('enspara_tpu.msm.builders', 'enspara.msm.builders')


class _ConfigUnpickler(pickle.Unpickler):
    """Unpickles ``config.pkl``: a builder pickled by the JAX package or by
    upstream enspara becomes this package's builder of the same name; any
    other global of the JAX package is refused (loading it would import
    the JAX package and jax)."""

    def find_class(self, module, name):
        if module in _FOREIGN_BUILDERS:
            if name.startswith('_') or not callable(
                    getattr(builders, name, None)):
                raise DataInvalid('the MSM config names the builder %s.%s, '
                                  'which enspara_tpu_torch does not have'
                                  % (module, name))
            return getattr(builders, name)
        if module == 'enspara_tpu' or module.startswith('enspara_tpu.'):
            raise DataInvalid('the MSM config pickles %s.%s, which '
                              'enspara_tpu_torch cannot load' % (module, name))
        return super().find_class(module, name)


class MSM(object):
    """Sklearn-style wrapper fitting a Markov state model from state
    assignments: counts at ``lag_time`` -> optional ergodic trim ->
    ``method`` (a builder from :mod:`enspara_tpu_torch.msm.builders` or
    its name as a string).
    """

    @classmethod
    def from_assignments(cls, assignments, **kwargs):
        m = cls(**kwargs)
        m.fit(assignments)
        return m

    def __init__(self, lag_time, method, trim=False, sliding_window=True,
                 max_n_states=None):
        self.method = (method if callable(method)
                       else getattr(builders, method))
        for name, val in (('lag_time', lag_time), ('trim', trim),
                          ('sliding_window', sliding_window),
                          ('max_n_states', max_n_states)):
            setattr(self, name, val)

    def fit(self, assigns):
        tcounts = assigns_to_counts(
            assigns,
            max_n_states=self.max_n_states,
            lag_time=self.lag_time,
            sliding_window=self.sliding_window)
        return self.fit_from_counts(tcounts)

    def fit_from_counts(self, tcounts):
        """Trim + build from a precomputed transition-count matrix —
        counts are additive over trajectories, so callers that already
        hold per-trajectory counts (e.g. bootstrap resampling) can
        skip the re-count."""
        self.mapping_, tcounts = self._trim_or_identity(tcounts)
        self.tcounts_, self.tprobs_, self.eq_probs_ = self.method(tcounts)
        return self

    def _trim_or_identity(self, tcounts):
        n_raw = tcounts.shape[0]
        if not self.trim:
            return TrimMapping((s, s) for s in range(n_raw)), tcounts
        mapping, kept = trim_disconnected(tcounts)
        logger.info('After ergodic trimming, %s of %s states remain',
                    len(mapping.to_original), n_raw)
        return mapping, kept

    @property
    def n_states_(self):
        try:
            probs = self.tprobs_
        except AttributeError:
            raise ImproperlyConfigured(
                'MSM must be fit before it has a number of '
                'states.') from None
        assert probs.shape[0] == self.tcounts_.shape[0]
        return probs.shape[0]

    @property
    def config(self):
        return {
            'lag_time': self.lag_time,
            'sliding_window': self.sliding_window,
            'trim': self.trim,
            'method': self.method,
        }

    @property
    def result_(self):
        if getattr(self, 'tcounts_', None) is not None:
            return {
                'tcounts_': self.tcounts_,
                'tprobs_': self.tprobs_,
                'eq_probs_': self.eq_probs_,
                'mapping_': self.mapping_,
            }
        return None

    def __eq__(self, other):
        if self is other:
            return True
        if self.config != other.config:
            return False
        mine, theirs = self.result_, other.result_
        if mine is None or theirs is None:
            return mine is theirs

        if self.mapping_ != other.mapping_:
            return False
        if not np.array_equal(np.asarray(self.eq_probs_),
                              np.asarray(other.eq_probs_)):
            return False
        if any(a.shape != b.shape for a, b in
               ((self.tcounts_, other.tcounts_),
                (self.tprobs_, other.tprobs_))):
            return False

        # counts: exact sparse equality
        mismatch = (sparse.csr_matrix(self.tcounts_)
                    != sparse.csr_matrix(other.tcounts_))
        if mismatch.nnz:
            return False

        # probabilities: identical sparsity pattern, values to fp tol
        ri, ci, vi = sparse.find(sparse.csr_matrix(self.tprobs_))
        rj, cj, vj = sparse.find(sparse.csr_matrix(other.tprobs_))
        return (np.array_equal(ri, rj) and np.array_equal(ci, cj)
                and np.allclose(vi, vj))

    def __repr__(self):
        return 'MSM:' + str({'config': self.config, 'fit': self.result_})

    __str__ = __repr__

    @classmethod
    def load(cls, path, manifest='manifest.json'):
        """Load an MSM from its manifest directory, or from a zip
        archive of one (an extension — the reference declares zip
        support but raises NotImplementedError, msm.py:191). A manifest
        of the JAX package or of upstream enspara loads with this
        package's builder of the pickled name."""
        if not os.path.isdir(path):
            import zipfile as _zipfile
            if not _zipfile.is_zipfile(path):
                raise DataInvalid(
                    '%r is neither an MSM manifest directory nor a '
                    'zip archive of one' % path)
            with tempfile.TemporaryDirectory() as staging:
                with _zipfile.ZipFile(path) as zf:
                    for info in zf.infolist():
                        # reject traversal before extracting
                        dest = os.path.realpath(
                            os.path.join(staging, info.filename))
                        if not dest.startswith(
                                os.path.realpath(staging) + os.sep):
                            raise DataInvalid(
                                'zip member escapes the archive '
                                'root: %r' % info.filename)
                    zf.extractall(staging)
                return cls.load(staging, manifest=manifest)

        with open(os.path.join(path, manifest)) as f:
            names = json.load(f)

        def part(key):
            return os.path.join(path, names[key])

        with open(part('config'), 'rb') as f:
            msm = cls(**_ConfigUnpickler(f).load())
        msm.mapping_ = TrimMapping.load(part('mapping_'))
        msm.eq_probs_ = np.loadtxt(part('eq_probs_'))
        msm.tcounts_ = mmread(part('tcounts_'))
        msm.tprobs_ = mmread(part('tprobs_'))
        return msm

    def save(self, path, force=False, zipfile=False, **filenames):
        """Serialize to a manifest directory: mapping.csv, tcounts.mtx,
        tprobs.mtx, eq-probs.dat, config.pkl, manifest.json — or, with
        ``zipfile=True``, to a single zip archive of that layout (an
        extension; the reference declares the flag but raises)."""
        names = {'mapping_': 'mapping.csv',
                 'tcounts_': 'tcounts.mtx',
                 'tprobs_': 'tprobs.mtx',
                 'eq_probs_': 'eq-probs.dat',
                 'config': 'config.pkl'}
        names.update(filenames)

        emitters = {
            'mapping_': ('w', self.mapping_.write),
            'tcounts_': ('wb', lambda f: mmwrite(
                f, sparse.coo_matrix(self.tcounts_))),
            'tprobs_': ('wb', lambda f: mmwrite(
                f, sparse.coo_matrix(self.tprobs_), precision=20)),
            'eq_probs_': ('wb', lambda f: np.savetxt(
                f, np.array(self.eq_probs_))),
            'config': ('wb', lambda f: pickle.dump(self.config, f)),
        }

        # stage the whole directory, then move it into place so a failed
        # serialization can't leave a half-written model behind
        with tempfile.TemporaryDirectory(
                prefix=os.path.basename(path)) as staging:
            with open(os.path.join(staging, 'manifest.json'), 'w') as f:
                json.dump(names, f, sort_keys=True, indent=4,
                          separators=(',', ': '))
            for key, (mode, emit) in emitters.items():
                with open(os.path.join(staging, names[key]), mode) as f:
                    emit(f)

            if zipfile:
                import zipfile as _zipfile
                if os.path.exists(path):
                    if not force:
                        raise DataInvalid(
                            '%r exists (pass force=True to overwrite)'
                            % path)
                    # force must also replace a prior DIRECTORY-format
                    # model at the same path, not hand ZipFile a dir
                    if os.path.isdir(path):
                        shutil.rmtree(path)
                    else:
                        os.remove(path)
                with _zipfile.ZipFile(path, 'w',
                                      _zipfile.ZIP_DEFLATED) as zf:
                    for fn in sorted(os.listdir(staging)):
                        zf.write(os.path.join(staging, fn), fn)
                return

            if os.path.exists(path):
                if not force:
                    raise DataInvalid(
                        '%s exists; pass force=True to overwrite'
                        % path)
                if os.path.isdir(path):
                    shutil.rmtree(path)
                else:                     # e.g. a prior zip-format save
                    os.remove(path)
            shutil.copytree(staging, path)
