"""Plain PyTorch references of the cells' configurations.

They import nothing of the port and take nothing it made: each works out
the expected film of its configuration from the benchmark's own inputs
(scenes/), by an independent Monte Carlo estimator, in the precision it is
given (the control runs them a step below the configuration's)."""
