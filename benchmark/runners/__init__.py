"""Runners of the traffic mixes: one module a runner, named by the mix's ``runner`` key."""
