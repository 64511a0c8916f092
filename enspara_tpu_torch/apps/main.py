"""`enspara` dispatcher: route a subcommand to its app's main
(counterpart of ``enspara_tpu/apps/main.py:12-64``, same subcommands).

    python -m enspara_tpu_torch.apps.main cluster --features f*.npy ...

``cluster``, ``implied``, ``reassign``, ``cards``, ``entropy``,
``smfret-dyes`` (the explicit-dye half of smFRET) and ``smfret-clouds``
(the point-cloud half) run the port's apps.
"""

import argparse
import importlib
import sys

# subcommand -> the port's app module
_APP_MODULES = {
    'cluster': '.cluster',
    'implied': '.implied_timescales',
    'reassign': '.reassign',
    'cards': '.collect_cards',
    'entropy': '.shannon_entropy',
    'smfret-dyes': '.smFRET_dye_MC',
    'smfret-clouds': '.smFRET_point_clouds',
}


def identify_app(argv):
    """Parse ``argv`` (``['enspara', appname, *appargs]``) into the app's
    ``main`` and its arguments. Help flags after the app name go to the
    app's own parser, not the dispatcher's."""
    parser = argparse.ArgumentParser(
        prog='enspara',
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
        description='Main entry point for enspara_tpu_torch apps.')
    parser.add_argument('appname', choices=set(_APP_MODULES),
                        help='Name of the application.')
    parser.add_argument('appargs', nargs=argparse.REMAINDER,
                        help='Arguments to the app.')

    # help flags beyond position 1 belong to the app's parser: set them
    # aside and re-append after parsing
    deferred = []
    kept = argv[:2]
    for tok in argv[2:]:
        (deferred if tok in ('--help', '-h') else kept).append(tok)
    argv[:] = kept

    args = parser.parse_args(argv[1:])
    args.main = importlib.import_module(_APP_MODULES[args.appname],
                                        package=__package__).main
    args.appargs.extend(deferred)
    return args


def main(argv=None):
    args = identify_app(sys.argv if argv is None else argv)
    try:
        # [appname] + appargs is the app's full argv, the help flags
        # identify_app set aside included
        args.main([args.appname] + args.appargs)
    except Exception:
        sys.stderr.write(
            'An unexpected error has occurred; please consider filing '
            'an issue at the project issue tracker.\n')
        raise
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv))
