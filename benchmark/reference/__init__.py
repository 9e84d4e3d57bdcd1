"""Plain PyTorch references of the benchmark's configurations. They import
nothing of the program and take nothing it made: each works out its own
calibration, scales and rounding from the benchmark's weights and
inputs."""
