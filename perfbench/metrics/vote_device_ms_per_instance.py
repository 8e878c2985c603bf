"""The reader of `vote_device_ms_per_instance` and of its splits by what they move
(`vote_device_ms_per_instance.eval`, `vote_device_ms_per_instance.stream`):
`perfbench/spec.py` falls back to it by the name before the split."""

from __future__ import annotations

from typing import Optional

from perfbench.metrics import _program


def read(ctx) -> Optional[float]:
    """Device time of the vote stages (`center_vote`, `backvote`,
    `cone_vote`, each between its marker and the next `stage_mark_end`) of
    the group programs and the singles' programs, per real instance."""
    return _program.stage_ms_per_instance(ctx, ("center_vote", "backvote", "cone_vote"))
