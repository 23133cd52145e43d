"""Detection models of the port (YOLOv8 family)."""
