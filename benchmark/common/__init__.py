"""The benchmark's yardstick: arithmetic, traffic, tracing and the run loop
shared by every cell. Nothing here imports the program at module level."""
