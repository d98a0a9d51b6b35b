"""The closed loop: a fixed pool of clients, each sending its next canvas
when the last returns (``serve.run_closed``)."""

from benchmark.drivers.serve import run_closed as run  # noqa: F401
