"""Multi-rank execution: the landmark group, sharded bundle adjustment."""
