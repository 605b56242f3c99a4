"""Traffic generators: numpy only, every draw from the run's seed."""
