"""Static profiles of the port's functions."""
