"""Plain numpy references, one module a configuration, named as the
configuration is. Each has ``expected(events, config)``: the rows the
job must emit for the generator's events, as columns. They import
nothing of the program."""
