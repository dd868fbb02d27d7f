"""ZeRO-1: split the optimizer's moments over the data dim.

Counterpart of ``repro.optim.zero``.  Adam's ``mu`` and ``nu`` are
elementwise, so any dim may be split without changing the arithmetic.
``zero1_state_specs`` takes the parameters' specs and adds the data dim to
the first dim that is not already split and is longer than 1 (the
parameter's spec when there is none), so the moments' memory scales as
1/|data|.
"""
from __future__ import annotations

from repro_torch.launch.sharding import P, tree_map


def _add_data_axis(spec, shape, data_axis: str = "data") -> P:
    parts = list(spec) if spec is not None else []
    parts += [None] * (len(shape) - len(parts))
    for i, p in enumerate(parts):
        if p is None and shape[i] > 1:
            parts[i] = data_axis
            break
    return P(*parts)


def zero1_state_specs(param_specs, param_shapes, data_axis: str = "data"):
    """The moments' specs, in the tree of ``param_specs``; ``param_shapes``
    is a tree of the same structure whose leaves are shapes or have
    ``.shape``."""
    return tree_map(lambda spec, s: _add_data_axis(
        spec, tuple(getattr(s, "shape", s)), data_axis),
        param_specs, param_shapes)
