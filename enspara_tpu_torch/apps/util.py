"""Shared CLI helpers (counterpart of ``enspara_tpu/apps/util.py``)."""

import argparse
import os
from glob import glob


class readable_dir(argparse.Action):
    """Argparse action checking the option's parent directory exists and
    is readable."""

    def __call__(self, parser, namespace, values, option_string=None):
        parent = os.path.dirname(os.path.abspath(values))
        problem = ('not a valid path' if not os.path.isdir(parent)
                   else None if os.access(parent, os.R_OK)
                   else 'not a readable dir')
        if problem is not None:
            raise argparse.ArgumentTypeError(
                'readable_dir:%s is %s' % (parent, problem))
        setattr(namespace, self.dest, values)


def expand_files(pgroups):
    """Glob-expand each file group; a pattern that matches nothing is
    kept as given."""
    expanded = []
    for pgroup in pgroups:
        expanded.append([])
        for p in pgroup:
            hits = sorted(glob(p))
            expanded[-1].extend(hits if hits else [p])
    return expanded
