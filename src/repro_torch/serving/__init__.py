"""Serving of the port: LM decoding with continuous batching
(serving/engine.py) and federated inference (serving/federated.py)."""
from repro_torch.serving.engine import Request, ServingEngine  # noqa: F401
from repro_torch.serving.federated import (AnswerCache,  # noqa: F401
                                           FederatedServingEngine,
                                           LocalPartyBackend, ServeRequest,
                                           answer_serve_query)
