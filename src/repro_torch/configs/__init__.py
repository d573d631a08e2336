"""Model configurations of the LM scaffold: ``ModelConfig`` (``base.py``),
one module per architecture with its public ``source``, and the registry
(``registry.py``)."""
