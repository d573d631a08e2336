"""Training: the asynchronous executors (``async_exec``)."""
