#!/usr/bin/env python3
"""The port's headline benchmark on an NVIDIA card: nine generated
families, each planned with AUTO and timed with the chained protocol; one
compact JSON line on stdout, the full record in
``chiprun_out/bench_torch_latest.json``.  ``bench.py`` beside it is the JAX
package's.

    python3 bench_torch.py [--device cuda|cpu] [--out-dir DIR]

The logic is ``spmv_tpu_torch/bench/headline.py``.
"""

import sys

from spmv_tpu_torch.bench import headline

if __name__ == "__main__":
    sys.exit(headline.main())
