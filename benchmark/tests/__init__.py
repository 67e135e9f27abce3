"""Tests of the benchmark that run on the CPU, and one marked ``cuda``."""
