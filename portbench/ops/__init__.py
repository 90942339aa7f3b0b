"""ops of the benchmark, each found by the name its entry gives."""
