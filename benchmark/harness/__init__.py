"""The parts every cell shares: finding a cell's files, traffic, weights,
tracing and the result line."""
