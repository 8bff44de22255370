"""The benchmark of the PyTorch and CUDA port (``eradiate_kernel_tpu_torch``).

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the CUDA card and
prints one JSON line of results last. Cells, configurations, traffic mixes
and per-layer metrics are files found by their names (see run.py).
"""
