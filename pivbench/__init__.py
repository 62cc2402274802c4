"""The benchmark of opticalflow_ri_tpu_torch on NVIDIA GPUs: one cell a run
(``python3 -m pivbench.run``), its cells in ``BENCHMARK.json`` at the root
of the checkout, everything that belongs to a configuration, a traffic
mix, a per-layer metric or a roofline stage in files of its own here
(``spec.py``).  It imports neither JAX nor the JAX package."""
