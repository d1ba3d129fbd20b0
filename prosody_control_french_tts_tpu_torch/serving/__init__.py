"""Serving: the batched SSML prediction service (break tagger, optional
prosody head) behind a stdlib HTTP front end."""

from .batcher import MicroBatcher  # noqa: F401
from .predictor import SSMLPredictor  # noqa: F401
