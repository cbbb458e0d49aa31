"""The yardstick: device checks, seeds, traces, counts and comparisons."""
