"""The open loop: Poisson arrivals at the mix's fixed rate
(``serve.run_open``)."""

from benchmark.drivers.serve import run_open as run  # noqa: F401
