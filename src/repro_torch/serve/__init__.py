"""Serving: the batched LM decode engine (counterpart of ``repro.serve``;
the multi-tenant ``SpGEMMService`` is not ported yet, ROADMAP Queue A
item 9)."""
from repro_torch.serve.engine import Request, ServeEngine, greedy_generate

__all__ = ["Request", "ServeEngine", "greedy_generate"]
