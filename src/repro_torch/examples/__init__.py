"""Runnable examples of the port (counterparts of the reference's
``examples/``): ``python -m repro_torch.examples.<name>`` for
``quickstart``, ``node_embeddings`` and ``quadratic_sensing``; each runs on
the card by default and takes ``--device cpu``."""
