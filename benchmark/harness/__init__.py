"""The benchmark's general machinery: cells found by name, seeded inputs
and weights, the profiler's reading, the result line."""
