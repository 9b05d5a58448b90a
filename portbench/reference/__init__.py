"""The plain reference that decides ``correct``: one step of the port's
``Simulation.run_step`` in plain torch (``step``), and how what the program
produced is held to it (``compare``).  Imports nothing of the program and
nothing of the JAX package."""
