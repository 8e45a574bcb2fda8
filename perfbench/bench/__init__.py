"""The harness: spec loading, traffic, weights, the timed windows, the
trace reduction and the correctness check.  Only :mod:`.program`
imports the port."""
