"""Evaluation: depth maps and point clouds of MVSNet-format scans (cli)."""
