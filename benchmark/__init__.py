"""The benchmark of the PyTorch and CUDA port (``cp360_tpu_torch``).

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Every configuration, cell, traffic mix and per-layer metric is a file of
its own, found by name: ``configs/<config>.json``, ``workloads/<cell>.json``,
``traffic/<mix>.json`` (read by the generator its ``driver`` names in
``drivers/``) and ``metrics/<metric>.py``.  ``reference/`` is the plain
float32 model the outputs are checked against.
"""
