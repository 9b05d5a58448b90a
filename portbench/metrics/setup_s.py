"""Seconds from the start of the process to the window's first step:
imports, the kernels' build or load, the inputs, the simulation and its
warm-up."""


def read(ctx):
    return ctx.setup_s
