"""Shared CLI plumbing (``detjax/cli/common.py``): ``--set group.field=
value`` override parsing."""

from __future__ import annotations

import ast


def parse_overrides(pairs) -> dict:
    """['a.b=1', 'c.d=(2,3)'] -> {'a.b': 1, 'c.d': (2, 3)} (literals when
    they parse, raw strings otherwise)."""
    out = {}
    for p in pairs or []:
        key, _, val = p.partition("=")
        try:
            out[key] = ast.literal_eval(val)
        except (ValueError, SyntaxError):
            out[key] = val
    return out
