"""The port's benchmark: one cell of ``BENCHMARK.json`` a run.

``python3 -m portbench.run --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of the PyTorch and CUDA port
(``repro_torch``) on the card and prints one JSON result line.  Every
configuration (``configs/``), traffic mix (``traffic/``) and per-layer
metric (``metrics/``) is a file of its own, found by the name that
``BENCHMARK.json`` gives it.
"""
