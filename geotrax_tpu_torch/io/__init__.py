"""Frame sources of the port (numpy only)."""
