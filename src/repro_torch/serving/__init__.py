"""Federated inference serving of the port (serving/federated.py). The
reference's LLM decode engine (serving/engine.py) is not ported yet
(ROADMAP.md, Queue 1 item 11)."""
from repro_torch.serving.federated import (AnswerCache,  # noqa: F401
                                           FederatedServingEngine,
                                           LocalPartyBackend, ServeRequest,
                                           answer_serve_query)
