"""Entry points of the port: Stage-1 training (``run.train``)."""
