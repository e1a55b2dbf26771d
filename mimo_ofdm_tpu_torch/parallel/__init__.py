"""The Monte-Carlo loop of the port (``parallel/montecarlo.py``) and its
scale-out over ``torch.distributed``: collectives, the ``(dp, tp)``
sharded rounds, the multi-process bootstrap and the weak-scaling harness."""
