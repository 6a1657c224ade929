#!/usr/bin/env python3
"""Run one benchmark cell of r3det_tpu_torch once, on the cards of this
machine, and print its result as the last line of standard output:

    python3 portbench/run.py --workload CELL --seed N --seconds S --trace 0|1

See ``bench/cli.py``. The compile caches live in fixed directories of the
checkout: the program's own ``r3det_tpu_torch/build/`` and, for Triton
and PyTorch's extension builder, ``portbench/.cache/``.
"""
import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
os.environ['TRITON_CACHE_DIR'] = os.path.join(HERE, '.cache', 'triton')
os.environ['TORCH_EXTENSIONS_DIR'] = os.path.join(HERE, '.cache',
                                                  'torch_extensions')
os.environ['USE_FLAX'] = '0'
sys.path[:] = [ROOT] + [p for p in sys.path
                        if os.path.abspath(p or '.') != HERE]

from portbench.bench.cli import main  # noqa: E402

if __name__ == '__main__':
    sys.exit(main(sys.argv[1:], T0))
