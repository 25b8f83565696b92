"""Run one cell of BENCHMARK.json once.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the program under test
(``evam_tpu_torch``). Exits non-zero, printing no result, without as
many CUDA devices as the cell asks for.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from gpubench.harness.cell import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
