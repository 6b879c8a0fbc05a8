"""The benchmark of the PyTorch/CUDA port (``repro_torch``).

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``. Everything that
measures lives here: the input generator, the block plan's arithmetic,
the byte counts and peaks, the trace reduction, the plain reference and
the comparison that decides ``correct``. The program supplies only the
system under test and its counters.
"""
