"""Command-line entry points of the port: ``python -m
repro_torch.launch.lda`` (train; ``--backend net`` through a parameter
server and a worker pool, ``--devices N`` over a mesh of N rank processes,
whose layout ``launch.mesh`` holds), ``python -m repro_torch.launch.topic_serve``
(train -> snapshot -> serve), ``python -m repro_torch.launch.ps_server``
(a standalone parameter server), ``python -m
repro_torch.launch.net_smoke`` (the network plane's fault drill) and
``python -m repro_torch.launch.obs_report`` (a text summary of an obs
directory, read on the host).  They orchestrate through
``repro_torch.api``, ``repro_torch.serve`` and ``repro_torch.ps.net``
only.  The LM's launchers are ``python -m repro_torch.launch.serve``
(batched generation) and ``python -m repro_torch.launch.train`` (training
on the Markov-Zipf data).  All of them run on the card unless given
``--device cpu``."""
