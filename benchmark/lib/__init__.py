"""What the benchmark's drivers, metrics and checks share."""
