"""``repro_torch.api`` -- the estimator API: train a model, then serve it.

    from repro_torch import api

    corp  = synthetic_corpus(...)                      # data/corpus.py
    job   = api.LDAJob(corpus=corp, num_topics=1000,
                       route=api.HybridRoute(hot_words=2000))
    model = api.APSLDA(job).fit()                      # on the card
    theta = model.transform(unseen_docs)               # fold-in
    scores = model.score(queries, docs)                # topic-smoothed ranking
    pub   = model.publisher()                          # -> TopicService

``TopicModel(nwk, nk, cfg)`` also wraps counts trained elsewhere.
"""
from repro_torch.api.callbacks import (Callback, CheckpointCallback,
                                       EvalCallback, LogCallback,
                                       PublishCallback, SweepView,
                                       TraceCallback)
from repro_torch.api.estimator import APSLDA
from repro_torch.api.job import (IN_PROCESS, NET, SPMD, CheckpointPolicy,
                                 JobValidationError, LDAJob)
from repro_torch.api.model import TopicModel, resolve_device
from repro_torch.api.session import Session, SessionResult
from repro_torch.obs import ObsConfig
from repro_torch.ps import CooRoute, DenseRoute, HybridRoute, PushRoute

__all__ = [
    "APSLDA", "LDAJob", "TopicModel", "Session", "SessionResult",
    "CheckpointPolicy", "JobValidationError", "IN_PROCESS", "NET", "SPMD",
    "Callback", "CheckpointCallback", "EvalCallback", "LogCallback",
    "PublishCallback", "SweepView", "TraceCallback", "ObsConfig",
    "CooRoute", "DenseRoute", "HybridRoute", "PushRoute", "resolve_device",
]
