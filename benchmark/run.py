"""Run one cell of the benchmark once, as the check runs it::

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout (see benchmark/README.md).
"""

import sys

from benchmark.harness import main

if __name__ == "__main__":
    sys.exit(main())
