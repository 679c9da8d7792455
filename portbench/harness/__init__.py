"""What every cell of the benchmark shares: finding its files by name,
the card, the weights and inputs drawn from the seed, host spans, the
profiler's trace and its reduction, the check against the reference, and
the guard against loading JAX."""
