"""The run's result: the check that no JAX module is loaded, the numbers
compared beside their limits, and the one JSON line."""

from __future__ import annotations

import json
import sys
from typing import Dict, Iterable, List

#: top-level module names that no run may load: JAX and the JAX package
BANNED = ("jax", "jaxlib", "flax", "plumekit")


def banned_modules(names: Iterable[str]) -> List[str]:
    """The loaded modules whose top-level name (before the first dot) is
    banned, compared whole: ``plumekit_torch`` passes, ``plumekit``
    fails."""
    return sorted(n for n in names if n.split(".")[0] in BANNED)


def emit(result: dict, checks: Dict[str, dict], stream=None) -> None:
    """Print the numbers compared as the last lines of standard error and
    the result as the last line of standard output, ``checks`` its last
    key."""
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r}, "
              f"{c['rule']})", file=sys.stderr)
    sys.stderr.flush()
    line = dict(result)
    line["checks"] = {k: {"value": v["value"], "limit": v["limit"]}
                      for k, v in checks.items()}
    print(json.dumps(line), file=stream or sys.stdout, flush=True)
