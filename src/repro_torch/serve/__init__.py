"""Serving: the batched LM decode engine and the multi-tenant SpGEMM
service (counterpart of ``repro.serve``)."""
from repro_torch.serve.engine import Request, ServeEngine, greedy_generate
from repro_torch.serve.spgemm_service import (
    DeadlineExceeded, QueueFull, ServeKnobs, SpGEMMService, Ticket)

__all__ = ["ServeEngine", "Request", "greedy_generate",
           "SpGEMMService", "ServeKnobs", "Ticket", "QueueFull",
           "DeadlineExceeded"]
