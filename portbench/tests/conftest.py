"""Shared fixtures of the benchmark's own tests: the cells cut to a size the
CPU runs in seconds (the program's plain versions stand in for its kernels
there)."""
from __future__ import annotations

import copy

import pytest
import torch

from portbench import cell

torch.set_num_threads(2)


def small_cell(name: str, nx: int, ppc: int = 0, steps: int = 0):
    """The cell's (workload, configuration) on an nx^2 grid of the same
    cell size, with `ppc` particles a cell and a deck of `steps` steps
    where given."""
    workload, config = cell.cell_files(name)
    config = copy.deepcopy(config)
    deck = config["deck"]
    f = nx / deck["nx"]
    deck["box_x"] *= f
    deck["box_y"] *= f
    deck["nx"] = deck["ny"] = nx
    if ppc:
        for sp in deck["species"]:
            sp["ppc"] = ppc
    if steps:
        dx = deck["box_x"] / nx
        dt = deck["dt_factor"] / (2.0 / dx ** 2) ** 0.5
        deck["sim_time"] = (steps + 0.5) * dt
    return workload, config


@pytest.fixture
def headline_small():
    return small_cell("headline-int8", 32, ppc=16)


@pytest.fixture
def laser_small():
    return small_cell("laser_plasma-f32", 64, steps=12)
