"""Training of the port: fused train forward, steps, optimizer, loop."""
