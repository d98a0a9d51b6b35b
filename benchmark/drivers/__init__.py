"""The drivers, one a kind of traffic (a mix's ``driver`` key): ``train``
(a closed loop of training steps), ``serve_open`` and ``serve_closed``
(requests into the program's micro-batching server). Each takes a
:class:`benchmark.harness.Run` and returns the result's fields."""
