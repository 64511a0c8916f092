"""Run one cell of the benchmark of ``enspara_tpu_torch`` once.

    python3 msmbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``msmbench/``
and ``enspara_tpu_torch/``. Prints one JSON line last on standard output;
see ``msmbench/harness/cli.py``.
"""

import os
import sys
import time

T0 = time.time()

if __name__ == '__main__':
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from msmbench.harness.cli import main
    sys.exit(main(sys.argv[1:], T0))
