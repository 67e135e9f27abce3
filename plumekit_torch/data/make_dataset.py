"""``make_dataset``: synthetic granules and a fire CSV into the reference
layout, the direct entry point of ``plumekit/data/make_dataset.py`` over
the port's parser (:func:`plumekit_torch.cli.cmd_make_dataset`)::

    python -m plumekit_torch.data.make_dataset --root data --n-granules 4
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> int:
    from plumekit_torch.cli import build_parser

    args = build_parser().parse_args(
        ["make_dataset", *(sys.argv[1:] if argv is None else argv)])
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
