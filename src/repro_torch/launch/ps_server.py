"""Standalone parameter-server process (DESIGN.md section 15).

    PYTHONPATH=src python -m repro_torch.launch.ps_server \
        --stream-dir experiments/stream --topics 100 --port 5055

Hosts the ``[V, K]`` topic-word table and ``[K]`` topic totals over the
``repro_torch.ps.net`` wire protocol (frame for frame the JAX package's,
so either package's workers may join); the vocabulary size comes from the
stream manifest (the workers read the same directory).  The server keeps
the tables in host memory and uses no card.  ``--port 0``
binds an ephemeral port; ``--ready-file`` writes the bound
``host:port`` once listening, which is how test harnesses and the CI
smoke discover the address.  The process serves until a client sends
``shutdown`` or it receives SIGINT/SIGTERM.
"""
from __future__ import annotations

import argparse
import signal
import sys
import threading


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="standalone network parameter server "
                    "(repro_torch.ps.net)")
    ap.add_argument("--stream-dir", required=True,
                    help="sharded stream directory (data.stream layout); "
                         "the manifest supplies the vocabulary size and "
                         "commit transactions persist z files here")
    ap.add_argument("--topics", type=int, required=True,
                    help="number of topics K (the table's column count)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="TCP port (0: pick a free one)")
    ap.add_argument("--ready-file", default=None,
                    help="write the bound host:port here once listening")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)

    from repro_torch.data import stream as stream_mod
    from repro_torch.ps.net import PSServer

    reader = stream_mod.ShardedCorpusReader(args.stream_dir)
    log = (lambda *a: None) if args.quiet else print
    srv = PSServer(reader.meta.vocab_size, args.topics, host=args.host,
                   port=args.port, stream_dir=args.stream_dir,
                   log_fn=log).start()
    if args.ready_file:
        with open(args.ready_file, "w") as f:
            f.write(srv.address)
    log(f"[ps_server] table [{reader.meta.vocab_size}, {args.topics}] "
        f"serving at {srv.address}")

    done = threading.Event()

    def _stop(signum, frame):
        done.set()

    signal.signal(signal.SIGINT, _stop)
    signal.signal(signal.SIGTERM, _stop)
    # wake on either a signal or a client-driven shutdown
    while not done.is_set() and not srv._stopping.is_set():
        done.wait(0.2)
    srv.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
