"""Run outputs: the scalar log and the depth panels (logging)."""
