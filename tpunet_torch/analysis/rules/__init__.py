"""The port's tpucheck rule registry."""

from __future__ import annotations

from typing import Dict, Tuple

from tpunet_torch.analysis.core import Rule
from tpunet_torch.analysis.rules.drift import DriftRule
from tpunet_torch.analysis.rules.instruments import InstrumentRule
from tpunet_torch.analysis.rules.launches import LaunchRule
from tpunet_torch.analysis.rules.threads import ThreadRule

ALL_RULES: Tuple[Rule, ...] = (
    LaunchRule(),
    ThreadRule(),
    DriftRule(),
    InstrumentRule(),
)


def rules_by_id() -> Dict[str, Rule]:
    return {r.id: r for r in ALL_RULES}
