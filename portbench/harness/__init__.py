"""The general parts of the benchmark: what a cell names is found by name
under portbench/configs, portbench/traffic, portbench/metrics and
portbench/bounds."""
