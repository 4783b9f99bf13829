"""The statements a cell proves, one module an AIR (the configuration's
`"air"`): `port_air()` gives the program's AIR object, and
`statements(log_n, count, rng, device)` makes `count` distinct statements,
each a (trace, public values) pair: an (n, width) canonical uint32 numpy
trace and a list of canonical ints, drawn from `rng` (a
`numpy.random.Generator` seeded from the run's seed)."""
