"""Geometric-consistency fusion of depth maps into point clouds (fusion)
and the PLY writer (ply)."""
