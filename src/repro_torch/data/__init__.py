"""Deterministic data pipeline (restart-reproducible, sharding-aware)."""
from repro_torch.data.pipeline import TokenPipeline, synthetic_batch

__all__ = ["TokenPipeline", "synthetic_batch"]
