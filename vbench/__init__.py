"""The benchmark of the PyTorch/CUDA port (``src/repro_torch``); its entry
point is ``vbench/run.py`` and its manifest ``BENCHMARK.json``."""
