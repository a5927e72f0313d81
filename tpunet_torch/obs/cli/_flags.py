"""The flag-anywhere argv split of the port's obs CLIs: a copy of
``split_flags`` from ``scripts/_gate_cli.py``. Unrecognized flags and
wrong positional counts are loud exit-2 usage errors."""

from __future__ import annotations

import sys
from typing import Dict, List, Sequence, Tuple, Union


def split_flags(argv: Sequence[str], value_flags: Sequence[str] = (),
                bool_flags: Sequence[str] = (),
                ) -> Union[int, Tuple[Dict[str, object], List[str]]]:
    """Flag-anywhere argv split shared by the gate CLIs.

    Returns ``(flags, positionals)`` where ``flags`` maps recognized
    flag names (without the ``--``) to their value (str) or True
    (bool flags); or an ``int`` exit code on a usage error (message
    already on stderr) — unknown flags are loud, same posture as
    ``load_record_argv``.
    """
    flags: Dict[str, object] = {}
    rest: List[str] = []
    args = list(argv)
    i = 0
    while i < len(args):
        a = args[i]
        if a in value_flags:
            if i + 1 >= len(args):
                print(f"{a} needs a value", file=sys.stderr)
                return 2
            flags[a.lstrip("-")] = args[i + 1]
            i += 2
            continue
        if a in bool_flags:
            flags[a.lstrip("-")] = True
            i += 1
            continue
        if a != "-" and a.startswith("-"):
            print(f"unrecognized arguments: {a}", file=sys.stderr)
            return 2
        rest.append(a)
        i += 1
    return flags, rest
