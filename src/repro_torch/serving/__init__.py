"""Serving: continuous batching over a persistent slot cache (the
counterpart of ``repro.serving``). :class:`ServingEngine` is the engine;
:class:`Request` / :class:`FIFOScheduler` the request lifecycle and slot
bookkeeping."""
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.scheduler import FIFOScheduler, Request, SlotError

__all__ = ["FIFOScheduler", "Request", "ServingEngine", "SlotError"]
