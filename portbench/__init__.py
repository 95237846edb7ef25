"""The port's benchmark: ``python3 portbench/run.py --workload <cell> ...``.

Cells, configurations and metrics are named in ``BENCHMARK.json``; each
configuration, traffic mix, metric reader, model adapter and plain
reference is a file of its own here, found by its name.
"""
