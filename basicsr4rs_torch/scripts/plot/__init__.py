"""Model complexity: parameters and FLOPs of the port's networks."""
