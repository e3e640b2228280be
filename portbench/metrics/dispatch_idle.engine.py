"""Share of the traced window in which the card runs nothing while the
stream stage is in ``dispatch`` and not in an NMS convergence read, in %:
the card starved by the host issuing work (``portbench/spans.py``)."""

from portbench.spans import dispatch_idle_percent as read  # noqa: F401
