"""State carried across packages as a flat dict of numpy arrays.

Keys: the six field names (``ex`` ... ``bz``), ``s{i}.{x,y,px,py,pz,w}``
per species, ``step`` and, where set, ``drift`` and ``window_x0``.
``sim_state_to_numpy`` reads any SimState with those attributes — this
package's, or the JAX package's (``np.asarray`` converts its arrays) — so
a test can build a state in one package and step the same particles in
the other.  The multi-device simulations' states are global arrays in storage
order on both sides (shard-major or striped buckets), so a JAX
``ShardedSimulation``'s or ``BalancedSimulation``'s state goes through
these two functions as it is, and setting ``state`` on the port's simulation
splits it onto its mesh.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .core.state import FIELD_NAMES, FieldState, ParticleState, SimState


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def sim_state_to_numpy(state) -> Dict[str, np.ndarray]:
    out = {name: _np(getattr(state.fields, name)) for name in FIELD_NAMES}
    for i, p in enumerate(state.species):
        for name in ParticleState._fields:
            out[f"s{i}.{name}"] = _np(getattr(p, name))
    out["step"] = _np(state.step)
    for name in ("drift", "window_x0"):
        if getattr(state, name, None) is not None:
            out[name] = _np(getattr(state, name))
    return out


def sim_state_from_numpy(d: Dict[str, np.ndarray],
                         device: torch.device) -> SimState:
    """Rebuild a SimState on `device` from copies of the arrays; dtypes
    are kept as they are."""
    def t(a):
        return torch.tensor(np.asarray(a), device=device)

    fields = FieldState(*(t(d[name]) for name in FIELD_NAMES))
    n_species = len({k.split(".")[0] for k in d if k.startswith("s")
                     and "." in k})
    species = tuple(
        ParticleState(*(t(d[f"s{i}.{name}"]) for name in ParticleState._fields))
        for i in range(n_species))
    extra = {name: t(d[name]) for name in ("drift", "window_x0")
             if name in d}
    return SimState(fields=fields, species=species, step=t(d["step"]),
                    **extra)
