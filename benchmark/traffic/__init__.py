"""Traffic: the generators (``scenes.py``, ``arrivals.py``) and the mixes
they read (``mixes/<traffic>.json``), one data file a mix."""
