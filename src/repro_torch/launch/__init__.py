"""Command-line entry points of the port: ``python -m
repro_torch.launch.lda`` (train) and ``python -m
repro_torch.launch.topic_serve`` (train -> snapshot -> serve).  Both
orchestrate through ``repro_torch.api`` and ``repro_torch.serve`` only, and
run on the card unless given ``--device cpu``."""
