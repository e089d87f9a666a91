"""Traffic generators' scenes: what the benchmark renders from a seed."""
