"""repro_torch.parallel: mesh-axis vocabulary (counterpart of
``repro.parallel``; the logical-axis ``Rules``, ``shard_map_compat`` and
``tp_dp_rules`` wait for the sharding rules, ROADMAP.md section 1, item 9)."""
from repro_torch.parallel.axes import LINK_KINDS, axis_link_kind

__all__ = ["LINK_KINDS", "axis_link_kind"]
