"""Citation tracker.

The reference decorates published methods with ``@cite`` and records which
were exercised (enspara/citation/citation.py:40, articles.json). We keep the
same user-facing behavior: decorated callables register their citation keys
on first use; ``citations_used()`` reports them.
"""

import functools

_ARTICLES = {
    'enspara': ('Porter, J.R., Zimmerman, M.I. & Bowman, G.R. (2019). '
                'Enspara: Modeling molecular ensembles with scalable data '
                'structures and parallel computing. J. Chem. Phys. 150, '
                '044108.'),
    'kcenters': ('Gonzalez, T.F. (1985). Clustering to minimize the maximum '
                 'intercluster distance. Theor. Comput. Sci. 38, 293-306.'),
    'khybrid': ('Beauchamp, K.A. et al. (2011). MSMBuilder2: Modeling '
                'conformational dynamics at the picosecond to millisecond '
                'scale. J. Chem. Theory Comput. 7(10), 3412-3419.'),
    'kcenters-tri-ineq': ('Zhao, Y., Sheong, F.K., Sun, J., Sander, P. & '
                          'Huang, X. (2013). A fast parallel clustering '
                          'algorithm for molecular simulation trajectories. '
                          'J. Comput. Chem. 34, 95-104.'),
    'prinz-mle': ('Prinz, J.-H. et al. (2011). Markov models of molecular '
                  'kinetics: Generation and validation. J. Chem. Phys. 134, '
                  '174105.'),
    'bace': ('Bowman, G.R. (2012). Improved coarse-graining of Markov state '
             'models via explicit consideration of statistical uncertainty. '
             'J. Chem. Phys. 137, 134111.'),
    'cards': ('Singh, S. & Bowman, G.R. (2017). Quantifying allosteric '
              'communication via both concerted structural changes and '
              'conformational disorder with CARDS. J. Chem. Theory Comput. '
              '13(4), 1509-1517.'),
    'exposons': ('Porter, J.R., Moeder, K.E., Sibbald, C.A., Zimmerman, '
                 'M.I., Hart, K.M., Greenberg, M.J. & Bowman, G.R. (2019). '
                 'Cooperative changes in solvent exposure identify cryptic '
                 'pockets, switches, and allosteric coupling. PNAS 116(52).'),
    'qcp': ('Theobald, D.L. (2005). Rapid calculation of RMSDs using a '
            'quaternion-based characteristic polynomial. Acta Cryst. A61, '
            '478-480.'),
    'tpt': ('Metzner, P., Schuette, C. & Vanden-Eijnden, E. (2009). '
            'Transition path theory for Markov jump processes. Multiscale '
            'Model. Simul. 7, 1192-1219.'),
    'pockets': ('Hendlich, M., Rippmann, F. & Barnickel, G. (1997). LIGSITE: '
                'automatic and efficient detection of potential small '
                'molecule-binding sites in proteins. J. Mol. Graph. Model. '
                '15, 359-363.'),
    'shrake-rupley': ('Shrake, A. & Rupley, J.A. (1973). Environment and '
                      'exposure to solvent of protein atoms. Lysozyme and '
                      'insulin. J. Mol. Biol. 79(2), 351-371.'),
}

_used = set()


def cite(key):
    """Decorator registering that calling the wrapped function uses the
    method published under ``key``."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            _used.add(key)
            return fn(*args, **kwargs)
        wrapper.__citation__ = _ARTICLES.get(key, key)
        return wrapper
    return deco


def citations_used():
    """Return the bibliography entries for every cited method used so far."""
    return {k: _ARTICLES.get(k, k) for k in sorted(_used)}


def all_articles():
    return dict(_ARTICLES)


def load_citation_db():
    """The citation database (reference: citation/citation.py
    load_citation_db, which reads articles.json; here the entries are
    inline)."""
    return dict(_ARTICLES)


def add_citation(key, entry):
    """Register an additional citation entry under ``key`` (reference:
    citation/citation.py add_citation)."""
    _ARTICLES[key] = entry


def citation_printer():
    """Format the bibliography of every method used so far as printable
    text (reference: citation/citation.py citation_printer)."""
    used = citations_used()
    if not used:
        return 'No cited methods have been used.'
    lines = ['Please cite the following articles:', '']
    for key, entry in used.items():
        lines.append('[%s]' % key)
        lines.append('  %s' % entry)
    return '\n'.join(lines)
