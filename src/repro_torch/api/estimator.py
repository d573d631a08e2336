"""The estimator: ``APSLDA(job).fit() -> TopicModel``.

The MLlib-style surface of the system (the paper's Spark integration
exposes LDA like this over Glint handles): a frozen ``LDAJob`` describes
the run, ``fit`` executes it through ``Session`` and returns a
``TopicModel`` ready to transform, score, save or publish:

    job   = LDAJob(corpus=corp, num_topics=1000,
                   route=HybridRoute(hot_words=2000))
    model = APSLDA(job).fit()                 # on the card
    theta = model.transform(unseen_docs)
"""
from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.api.callbacks import Callback
from repro_torch.api.job import LDAJob
from repro_torch.api.model import TopicModel
from repro_torch.api.session import Session, SessionResult
from repro_torch.device import Device


class APSLDA:
    """Asynchronous-parameter-server LDA estimator.

    The job is validated at construction (errors surface before any device
    work); ``fit`` may be called repeatedly -- each call runs a fresh
    session, and the same job gives the same counts.  ``device`` is where
    training runs and the fitted model lives: the card unless the caller
    passes another (``device="cpu"`` runs the plain PyTorch path).
    ``devices`` is an SPMD job's rank count (``Session``).
    """

    def __init__(self, job: LDAJob, log_fn=print, device: Device = None,
                 devices: Optional[int] = None):
        self.job = job.validate()
        self.log_fn = log_fn
        self.device = device
        self.devices = devices
        self.model_: Optional[TopicModel] = None
        self.result_: Optional[SessionResult] = None

    def fit(self, callbacks: Sequence[Callback] = ()) -> TopicModel:
        """Run the job end to end; returns the fitted ``TopicModel``.
        ``callbacks`` observe the run and never perturb it."""
        session = Session(self.job, log_fn=self.log_fn, device=self.device,
                          devices=self.devices)
        result = session.run(callbacks)
        model = TopicModel(result.nwk.to_dense(),
                           result.nk.pull_all().result(), session.cfg,
                           history=result.history, info=result.info,
                           device=session.device)
        self.model_ = model
        self.result_ = result
        return model
