"""The finding type every `repro_torch.analysis` engine reports (the
reference's `repro.analysis.report`).

`repro_torch.tools.repro_lint` prints findings as ``FAIL ...`` lines
under the ``# repro_lint: ...`` convention.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation.

    rule   -- kebab-case rule id (e.g. ``weight-f32-temporary``)
    where  -- location: ``file:line``, an aten op name, a collective, or
              a masked-leaf path
    detail -- what was seen there
    """

    rule: str
    where: str
    detail: str = ""

    def __str__(self) -> str:
        d = f": {self.detail}" if self.detail else ""
        return f"[{self.rule}] {self.where}{d}"
