"""Share of the traced window in which no operation ran on the card, in %
(the training step)."""

from portbench.trace import idle_percent as read  # noqa: F401
