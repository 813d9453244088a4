"""Entry points that are not CLIs of the package: block-size sweeps,
kernel timings, pore-detector training."""
