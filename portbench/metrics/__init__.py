"""One reader a metric: ``<name>.py`` for the metrics ``<name>`` and
``<name>.<anything>`` of BENCHMARK.json.  Each defines ``read(ctx)``, which
takes the run's ``portbench.cell.RunContext`` and returns the metric's
value, or None where the run has nothing to read (the harness then leaves
the metric out of its line)."""
