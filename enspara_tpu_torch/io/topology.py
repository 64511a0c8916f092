"""Minimal molecular topology: chains > residues > atoms.

Standalone replacement for the slice of mdtraj.Topology the reference
relies on (residue/atom iteration, name-based selection, element
lookup). Interoperates with the mdtraj HDF5 format's JSON topology
blocks, so files written by either library round-trip.
"""

import json

import numpy as np

__all__ = ['Topology', 'Atom', 'Residue', 'Chain', 'ELEMENT_RADII',
           'guess_element']

# van der Waals radii in nm (Bondi 1964), used by SASA and pockets
ELEMENT_RADII = {
    'H': 0.120, 'C': 0.170, 'N': 0.155, 'O': 0.152, 'S': 0.180,
    'P': 0.180, 'F': 0.147, 'Cl': 0.175, 'Br': 0.185, 'I': 0.198,
    'Na': 0.227, 'K': 0.275, 'Mg': 0.173, 'Ca': 0.231, 'Zn': 0.139,
    'Fe': 0.194, 'Se': 0.190, 'VS': 0.170, '': 0.170,
}

_STD_RESIDUES = frozenset([
    'ALA', 'ARG', 'ASN', 'ASP', 'CYS', 'GLN', 'GLU', 'GLY', 'HIS',
    'ILE', 'LEU', 'LYS', 'MET', 'PHE', 'PRO', 'SER', 'THR', 'TRP',
    'TYR', 'VAL', 'HSD', 'HSE', 'HSP', 'HID', 'HIE', 'HIP', 'CYX',
    'NLE', 'NME', 'ACE', 'MSE', 'SEP', 'TPO'])

def guess_element(atom_name, residue_name=''):
    """Element symbol from a PDB-style atom name."""
    name = atom_name.strip()
    if not name:
        return ''
    res = residue_name.strip().upper()
    if res in ('HOH', 'WAT', 'TIP3', 'SOL'):
        return 'O' if name.startswith('O') else 'H'
    stripped = name.lstrip('0123456789')
    # 'CA' is ambiguous (alpha carbon vs a calcium ion): only the
    # residue name can disambiguate — calcium-ion residues are named
    # for the ion, while every other residue's CA is carbon
    if stripped.upper() == 'CA' and res in ('CA', 'CAL', 'CA2'):
        return 'Ca'
    if len(stripped) >= 2 and stripped[:2].capitalize() in \
            ('Cl', 'Br', 'Na', 'Mg', 'Zn', 'Fe', 'Se') and \
            residue_name.strip() not in _STD_RESIDUES:
        return stripped[:2].capitalize()
    return stripped[0].upper() if stripped else ''


class Atom(object):
    __slots__ = ('name', 'element', 'index', 'residue', 'serial')

    def __init__(self, name, element, index, residue, serial=None):
        self.name = name
        self.element = element
        self.index = index
        self.residue = residue
        self.serial = serial if serial is not None else index + 1

    @property
    def radius(self):
        return ELEMENT_RADII.get(self.element, 0.170)

    def __repr__(self):
        return '%s-%s' % (self.residue, self.name)


class Residue(object):
    __slots__ = ('name', 'index', 'resSeq', 'chain', 'atoms', 'segment_id')

    def __init__(self, name, index, resSeq, chain, segment_id=''):
        self.name = name
        self.index = index
        self.resSeq = resSeq
        self.chain = chain
        self.atoms = []
        self.segment_id = segment_id

    @property
    def n_atoms(self):
        return len(self.atoms)

    def atom(self, i):
        return self.atoms[i]

    @property
    def is_protein(self):
        return self.name in _STD_RESIDUES

    @property
    def is_water(self):
        return self.name in ('HOH', 'WAT', 'TIP3', 'SOL', 'TIP4', 'TIP5')

    def __repr__(self):
        return '%s%s' % (self.name, self.resSeq)


class Chain(object):
    __slots__ = ('index', 'residues', 'chain_id')

    def __init__(self, index, chain_id=' '):
        self.index = index
        self.residues = []
        self.chain_id = chain_id

    @property
    def n_residues(self):
        return len(self.residues)

    @property
    def atoms(self):
        for r in self.residues:
            for a in r.atoms:
                yield a


class Topology(object):
    """Container of chains/residues/atoms with name-based selection."""

    def __init__(self):
        self._chains = []
        self._residues = []
        self._atoms = []

    # -- construction --------------------------------------------------

    def add_chain(self, chain_id=' '):
        c = Chain(len(self._chains), chain_id)
        self._chains.append(c)
        return c

    def add_residue(self, name, chain, resSeq=None, segment_id=''):
        r = Residue(name, len(self._residues),
                    resSeq if resSeq is not None else len(self._residues),
                    chain, segment_id)
        self._residues.append(r)
        chain.residues.append(r)
        return r

    def add_atom(self, name, element, residue, serial=None):
        a = Atom(name, element, len(self._atoms), residue, serial)
        self._atoms.append(a)
        residue.atoms.append(a)
        return a

    # -- access ---------------------------------------------------------

    @property
    def n_atoms(self):
        return len(self._atoms)

    @property
    def n_residues(self):
        return len(self._residues)

    @property
    def n_chains(self):
        return len(self._chains)

    @property
    def atoms(self):
        return iter(self._atoms)

    @property
    def residues(self):
        return iter(self._residues)

    @property
    def chains(self):
        return iter(self._chains)

    def atom(self, i):
        return self._atoms[i]

    def residue(self, i):
        return self._residues[i]

    def chain(self, i):
        return self._chains[i]

    def __repr__(self):
        return ('<Topology with %d chains, %d residues, %d atoms>'
                % (self.n_chains, self.n_residues, self.n_atoms))

    # -- selection ------------------------------------------------------

    def select(self, expr):
        """Evaluate a small selection mini-language covering the forms
        the reference uses: ``name X``, ``element X``, ``resname X``,
        ``resid N`` (residue *index*), ``resSeq N``, ``backbone``,
        ``sidechain``, ``protein``, ``water``, ``all``, combined with
        ``and``, ``or``, ``not`` and parentheses.
        """
        mask = _eval_selection(_tokenize(expr), self)
        return np.where(mask)[0]

    def subset(self, atom_indices):
        """New topology containing only the given atoms (in order)."""
        atom_indices = list(atom_indices)
        new = Topology()
        chain_map = {}
        res_map = {}
        for idx in atom_indices:
            a = self._atoms[idx]
            r = a.residue
            c = r.chain
            if c.index not in chain_map:
                chain_map[c.index] = new.add_chain(c.chain_id)
            if r.index not in res_map:
                res_map[r.index] = new.add_residue(
                    r.name, chain_map[c.index], r.resSeq, r.segment_id)
            new.add_atom(a.name, a.element, res_map[r.index], a.serial)
        return new

    def copy(self):
        return self.subset(range(self.n_atoms))

    def join(self, other):
        """Concatenated topology (self's atoms first)."""
        new = self.copy()
        for c in other.chains:
            nc = new.add_chain(c.chain_id)
            for r in c.residues:
                nr = new.add_residue(r.name, nc, r.resSeq, r.segment_id)
                for a in r.atoms:
                    new.add_atom(a.name, a.element, nr)
        return new

    def __eq__(self, other):
        if not isinstance(other, Topology):
            return NotImplemented
        if (self.n_atoms != other.n_atoms
                or self.n_residues != other.n_residues):
            return False
        for a, b in zip(self.atoms, other.atoms):
            if (a.name != b.name or a.element != b.element
                    or a.residue.name != b.residue.name
                    or a.residue.resSeq != b.residue.resSeq):
                return False
        return True

    # -- mdtraj-HDF5 JSON interop ----------------------------------------

    def to_json(self):
        chains = []
        for c in self._chains:
            residues = []
            for r in c.residues:
                atoms = [{'name': a.name, 'element': a.element or 'VS',
                          'index': a.index}
                         for a in r.atoms]
                residues.append({'name': r.name, 'index': r.index,
                                 'resSeq': int(r.resSeq),
                                 'segmentID': r.segment_id,
                                 'atoms': atoms})
            chains.append({'index': c.index, 'residues': residues})
        return json.dumps({'chains': chains, 'bonds': []})

    @classmethod
    def from_json(cls, s):
        data = json.loads(s)
        top = cls()
        pending = []
        for cdata in data['chains']:
            c = top.add_chain()
            for rdata in cdata['residues']:
                r = top.add_residue(rdata['name'], c,
                                    rdata.get('resSeq'),
                                    rdata.get('segmentID', ''))
                for adata in rdata['atoms']:
                    pending.append((adata.get('index',
                                              len(pending)),
                                    adata['name'],
                                    adata.get('element', ''), r))
        pending.sort(key=lambda t: t[0])
        for _, name, element, r in pending:
            if element in ('VS', 'virtual site', 'None'):
                element = guess_element(name, r.name)
            top.add_atom(name, element, r)
        return top


_BACKBONE = frozenset(['N', 'CA', 'C', 'O', 'OXT', 'H', 'H1', 'H2',
                       'H3', 'HA'])


def _tokenize(expr):
    expr = expr.replace('(', ' ( ').replace(')', ' ) ')
    return expr.split()


def _eval_selection(tokens, top):
    """Recursive-descent: or_expr := and_expr ('or' and_expr)*"""
    pos = [0]

    def peek():
        return tokens[pos[0]] if pos[0] < len(tokens) else None

    def take():
        t = tokens[pos[0]]
        pos[0] += 1
        return t

    n = top.n_atoms

    def primary():
        t = take()
        if t == '(':
            m = or_expr()
            assert take() == ')'
            return m
        if t == 'not':
            return ~primary()
        if t == 'all':
            return np.ones(n, bool)
        if t == 'none':
            return np.zeros(n, bool)
        if t == 'backbone':
            return np.array([a.name in _BACKBONE
                             and a.residue.is_protein
                             for a in top.atoms])
        if t == 'sidechain':
            return np.array([a.name not in _BACKBONE
                             and a.residue.is_protein
                             for a in top.atoms])
        if t == 'protein':
            return np.array([a.residue.is_protein for a in top.atoms])
        if t == 'water':
            return np.array([a.residue.is_water for a in top.atoms])
        if t in ('name', 'element', 'resname', 'resid', 'resSeq',
                 'residue', 'index', 'symbol'):
            vals = []
            while peek() is not None and peek() not in (
                    'and', 'or', 'not', ')'):
                nxt = peek()
                if nxt in ('name', 'element', 'resname', 'resid',
                           'resSeq', 'residue', 'index', 'symbol',
                           'backbone', 'sidechain', 'protein', 'water',
                           'all'):
                    break
                vals.append(take())
            if t == 'name':
                vs = set(vals)
                return np.array([a.name in vs for a in top.atoms])
            if t in ('element', 'symbol'):
                vs = set(vals)
                return np.array([a.element in vs for a in top.atoms])
            if t == 'resname':
                vs = set(vals)
                return np.array([a.residue.name in vs
                                 for a in top.atoms])
            if t == 'resid':
                vs = set(_expand_ranges(vals))
                return np.array([a.residue.index in vs
                                 for a in top.atoms])
            if t in ('resSeq', 'residue'):
                # mdtraj's 'residue' keyword selects by resSeq
                vs = set(_expand_ranges(vals))
                return np.array([a.residue.resSeq in vs
                                 for a in top.atoms])
            if t == 'index':
                vs = set(_expand_ranges(vals))
                return np.array([a.index in vs for a in top.atoms])
        raise ValueError('Cannot parse selection token %r' % t)

    def and_expr():
        m = primary()
        while peek() == 'and':
            take()
            m = m & primary()
        return m

    def or_expr():
        m = and_expr()
        while peek() == 'or':
            take()
            m = m | and_expr()
        return m

    return or_expr()


def _expand_ranges(vals):
    # merge "a to b" triplets (mdtraj-style ranges)
    out = []
    i = 0
    while i < len(vals):
        if i + 2 < len(vals) + 1 and i + 1 < len(vals) and \
                vals[i + 1] == 'to':
            out.extend(range(int(vals[i]), int(vals[i + 2]) + 1))
            i += 3
        elif 'to' in vals[i] and not vals[i].isdigit():
            a, b = vals[i].split('to')
            out.extend(range(int(a), int(b) + 1))
            i += 1
        else:
            out.append(int(vals[i]))
            i += 1
    return out
