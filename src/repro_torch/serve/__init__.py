"""Serving facade: ``TopicService`` trains, publishes and serves one topic
model in one object (``serve/topic_service.py``)."""
from repro_torch.serve.topic_service import TopicService, TrainingHandle

__all__ = ["TopicService", "TrainingHandle"]
