"""params.txt export and import, the reference's run-metadata sidecar (the
port's own copy of ``minipic_tpu.io.params``).

The writer mirrors ``PIC_2D.cpp:425-438`` (the same keys in the same
order, from ``Deck.params_txt``), so the reference's ``read_params``
(``File_reader.py:15-51``) reads the file; the reader follows its parsing
rules (int if the value has no '.' or 'e', float otherwise).
"""
from __future__ import annotations

import os
from typing import Dict

from ..core.config import Deck


def write_params(deck: Deck, folder: str) -> str:
    os.makedirs(folder, exist_ok=True)
    path = os.path.join(folder, "params.txt")
    with open(path, "w") as f:
        f.write(deck.params_txt())
    return path


def read_params(path: str) -> Dict:
    params: Dict = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#") or "=" not in line:
                continue
            key, val = (s.strip() for s in line.split("=", 1))
            try:
                params[key] = (float(val) if ("." in val or "e" in val.lower())
                               else int(val))
            except ValueError:
                params[key] = val
    return params
