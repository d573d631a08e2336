"""``repro_torch.api`` -- the serving half of the estimator API.

    from repro_torch.api import TopicModel

    model = TopicModel(nwk, nk, cfg)          # on the card (device="cuda")
    theta = model.transform(unseen_docs)      # fold-in
    scores = model.score(queries, docs)       # topic-smoothed ranking
"""
from repro_torch.api.model import TopicModel, resolve_device
from repro_torch.obs import ObsConfig

__all__ = ["TopicModel", "resolve_device", "ObsConfig"]
