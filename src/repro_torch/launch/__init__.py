"""Command-line entry points of the port: ``python -m
repro_torch.launch.lda`` (train; ``--backend net`` through a parameter
server and a worker pool), ``python -m repro_torch.launch.topic_serve``
(train -> snapshot -> serve), ``python -m repro_torch.launch.ps_server``
(a standalone parameter server) and ``python -m
repro_torch.launch.net_smoke`` (the network plane's fault drill).  They
orchestrate through ``repro_torch.api``, ``repro_torch.serve`` and
``repro_torch.ps.net`` only, and train on the card unless given ``--device
cpu``."""
