"""One reader a per-layer metric, ``<metric>.py``, loaded by path: each
defines ``read(record)``, which returns the metric from a traced run's
record or None when it finds nothing to read (the harness then leaves the
metric out). ``_read.py`` holds what several readers share."""
