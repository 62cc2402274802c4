"""Campaign harness of the port: the batch runner, the benchmark grid and the
per-config runner."""
