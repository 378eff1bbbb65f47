"""Static profiles of the port's functions (`launch_stats`) and the cost
walk of one run (`op_costs`)."""
