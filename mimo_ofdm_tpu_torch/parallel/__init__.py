"""The Monte-Carlo loop of the port (``parallel/montecarlo.py``)."""
