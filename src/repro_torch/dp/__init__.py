"""Differential privacy at the up-link codec seam: the clip-then-noise
mechanisms (``mechanisms``), the defended exchange that requires them
(``exchange.DPExchange``) and the RDP accountant that calibrates their
noise multiplier from a target epsilon (``accountant``). Nothing is
re-exported here: ``core/exchange.py`` imports ``mechanisms``, and
``exchange`` imports ``core/exchange.py``."""
