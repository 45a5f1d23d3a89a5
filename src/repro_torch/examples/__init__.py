"""Runnable examples of the port (counterparts of the reference's
``examples/``): ``python -m repro_torch.examples.<name>`` for
``quickstart``, ``node_embeddings``, ``quadratic_sensing``, ``train_lm``
and ``serve_lm``; each runs on the card by default and takes ``--device
cpu``."""
