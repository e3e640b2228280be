"""One reader a per-layer metric, found by the metric's name. Each
``read(obs)`` returns the value, or None where the run gave it nothing to
read (the harness then leaves the metric out of the line)."""
