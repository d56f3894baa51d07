"""spmvbench: the benchmark of ``spmv_tpu_torch`` on an NVIDIA H100.

Run one cell once, from the root of a checkout:

    python3 spmvbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cells, configurations and metrics are listed in ``BENCHMARK.json`` at
the root.  Each configuration, traffic mix and per-layer metric is a file
of its own that the harness finds by name (``core.py``):

* ``configs/<config>.json``: the deployment's sizes, its source, what was
  cut (``reduced``) and what was assumed; ``generator`` names
  ``generators/<generator>.py``, which makes the matrix from the seed;
* ``traffic/<traffic>.json``: the parameters of a traffic mix; ``loop``
  names ``loops/<loop>.py``, the closed loop the window drives;
* ``metrics/<metric>.py``: a reader that takes one per-layer metric from
  the traced run's record (``metrics/<stem>.py`` reads each
  ``<stem>.<suffix>`` that has no file of its own);
* ``reference/``: the plain PyTorch reference that decides ``correct``.

The harness reaches the port only through ``CsrMatrix``, ``create_handle``,
``spmv``, ``solvers.cg``, ``solvers.host_syncs`` and
``utils.profiling.predeal_profile``.  No module here imports JAX or the JAX
package, and ``reference/`` imports nothing of the port.
"""
