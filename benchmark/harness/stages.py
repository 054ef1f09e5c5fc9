"""The engine's stage seconds, read from the stage-timing lines its
Tracer prints at the end of a run (`utils/trace.Tracer.summary_lines`:
"     <stage> <seconds>s  <items> <unit> (<rate>/s)")."""

from __future__ import annotations

import re
from typing import Dict

_LINE = re.compile(r"^\s{5}(#\S+(?: \S+)*?)\s+(\d+\.\d+)s(?:\s|$)")


def parse(text: str) -> Dict[str, float]:
    """{stage name: seconds} of the last stage-timing block in `text`."""
    out: Dict[str, float] = {}
    block = text.rsplit("--- stage timings ---", 1)
    if len(block) < 2:
        return out
    for line in block[1].splitlines():
        m = _LINE.match(line)
        if m:
            out[m.group(1)] = out.get(m.group(1), 0.0) + float(m.group(2))
    return out
