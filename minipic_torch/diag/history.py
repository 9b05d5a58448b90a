"""Run history: the per-step diagnostics on the host, with wall-clock
throughput (the port's own copy of ``minipic_tpu.diag.history``: the same
JSON keys, ``energy_drift`` and ``steps_per_sec``).

Each step leaves its ``StepDiag`` scalars on the device; ``record`` stacks
one record's scalars there and reads them back in one device-to-host copy
(the JAX package's reads each, 3 + n_species syncs and the weight check).
"""
from __future__ import annotations

import json
import time
from typing import List, Optional

import torch


class RunHistory:
    """StepDiag + timing in plain lists; serializable to JSON."""

    def __init__(self):
        self.steps: List[int] = []
        self.time: List[float] = []
        self.field_energy: List[float] = []
        self.kinetic_energy: List[list] = []
        self.overflow: List[int] = []
        self.wall: List[float] = []
        # max/mean of StepDiag.shard_live: the work skew across devices
        # (1.0 on one device).
        self.live_skew: List[float] = []
        self._t0 = time.perf_counter()

    def record(self, step: int, dt: float, diag) -> None:
        """Append one step's record; raises when the int8 deposit ran on
        non-uniform live weights (it then deposits wrong currents)."""
        n_sp = diag.kinetic_energy.numel()
        parts = [diag.field_energy.reshape(1), diag.kinetic_energy.reshape(-1),
                 diag.overflow.reshape(1), diag.weight_nonuniform.reshape(1),
                 diag.shard_live.reshape(-1)]
        vals = torch.cat([a.to(torch.float64) for a in parts]).cpu().numpy()
        bad = int(vals[2 + n_sp])
        if bad > 0:
            raise RuntimeError(
                f"step {step}: int8 deposit engaged with NON-UNIFORM live "
                f"particle weights in {bad} species — the integer-ring "
                "deposit scales currents by the uniform q*max(w), so this "
                "run is depositing wrong currents. Use deposit='highest' "
                "for per-particle weights (simulation.int8_weight_violations)."
            )
        self.steps.append(int(step))
        self.time.append(float(step * dt))
        self.field_energy.append(float(vals[0]))
        self.kinetic_energy.append([float(k) for k in vals[1:1 + n_sp]])
        self.overflow.append(int(vals[1 + n_sp]))
        live = vals[3 + n_sp:]
        if len(live) > 0:
            mean = live.mean()
            self.live_skew.append(float(live.max() / mean) if mean > 0
                                  else 1.0)
        self.wall.append(time.perf_counter() - self._t0)

    def total_energy(self) -> list:
        return [f + sum(k) for f, k in zip(self.field_energy,
                                           self.kinetic_energy)]

    def energy_drift(self) -> float:
        tot = self.total_energy()
        if not tot or tot[0] == 0:
            return 0.0
        return max(abs(t - tot[0]) for t in tot) / abs(tot[0])

    def steps_per_sec(self) -> Optional[float]:
        if len(self.wall) < 2:
            return None
        return (self.steps[-1] - self.steps[0]) / max(
            1e-9, self.wall[-1] - self.wall[0])

    def to_json(self) -> str:
        return json.dumps(
            {
                "steps": self.steps,
                "time": self.time,
                "field_energy": self.field_energy,
                "kinetic_energy": self.kinetic_energy,
                "overflow": self.overflow,
                "wall": self.wall,
                "live_skew": self.live_skew,
            }
        )

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())
