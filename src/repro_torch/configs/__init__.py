"""Architecture configs, counterpart of ``repro.configs``: one module per
assigned architecture, copied as data.  ``get_config(name)`` returns the
full published config; ``smoke_config(name)`` returns the reduced
same-family config used by CPU tests.  The port runs the dense GQA family
(``models.transformer``); the others are here so that both packages see one
table."""
from repro_torch.configs.base import (ArchConfig, MLAConfig, MoEConfig,
                                      SHAPE_SETS, ShapeSpec)
from repro_torch.configs.registry import ARCH_IDS, get_config, smoke_config

__all__ = ["ArchConfig", "ARCH_IDS", "MLAConfig", "MoEConfig", "get_config",
           "smoke_config", "SHAPE_SETS", "ShapeSpec"]
