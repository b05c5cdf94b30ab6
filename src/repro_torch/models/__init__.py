"""Models of the port (the GCN so far)."""
