"""Plan scheduler and reference-parity plan classes."""
