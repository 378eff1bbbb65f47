"""The benchmark's frozen yardstick: the card's peaks and the work each
operation needs (copied from the port, so that a change to the port
cannot move what it is measured by)."""
